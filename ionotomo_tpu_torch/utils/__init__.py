"""Host-side utilities (port of ``ionotomo_tpu.utils``): checkpoints, the
JSONL metrics stream and the keyed random draws."""
