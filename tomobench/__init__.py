"""The benchmark of ionotomo_tpu_torch on one NVIDIA H100 (``run.py``)."""
