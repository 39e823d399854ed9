"""idle_pct.<unit>: the share of the traced sub-window in which no
kernel, copy or fill runs on the card, %."""
from tomobench.harness.layer import traced


def read(name, ctx):
    t = traced(name, ctx)
    if t is None or t[0].window_s <= 0:
        return None
    s = t[0]
    return 100.0 * (s.window_s - s.busy_s) / s.window_s
