"""Diagnostics plotting (matplotlib, host side; port of
``ionotomo_tpu.plotting``)."""
