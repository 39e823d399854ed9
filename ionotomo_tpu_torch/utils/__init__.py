"""Host-side utilities (port of ``ionotomo_tpu.utils``): checkpoints, the
JSONL metrics stream, the keyed random draws, the dense GP toolkit, the
structure-function diagnostics and the NaN-check mode."""
