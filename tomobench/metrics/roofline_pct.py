"""roofline_pct.<unit>: the least time the chip needs for the traced
sub-window's work (the driver's count: each operation's f32 operations
over 67 TFLOP/s or its bytes over 3.35 TB/s, the larger) over the card's
busy time in the sub-window, %. Independent of which kernels do the
work and how many launches they take."""
from tomobench.harness.layer import traced


def read(name, ctx):
    t = traced(name, ctx)
    if t is None or not t[0].busy_s or not t[0].work_s:
        return None
    return 100.0 * t[0].work_s / t[0].busy_s
