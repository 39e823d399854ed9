"""fft_ms.<unit>: the device time of cuFFT's kernels (the library's own
names, which all hold "fft") in the traced sub-window over its units of
work, ms. Reads nothing where no FFT ran."""
from tomobench.harness.layer import traced


def read(name, ctx):
    t = traced(name, ctx)
    if t is None:
        return None
    us = sum(e["dur"] for e in t[0].kernels if "fft" in e["name"].lower())
    return us * 1e-3 / t[1] if us else None
