"""Host-side utilities (port of ``ionotomo_tpu.utils``): checkpoints."""
