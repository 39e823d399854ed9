"""solve_p95_s: the 95th percentile (linear between order statistics) of
every solve's latency in the window, from its first call to the
synchronise after its field is final."""
import numpy as np


def read(name, ctx):
    if ctx["cell"].per_unit.get("solve") != 1:
        return None
    return float(np.percentile(np.asarray(ctx["window"].latencies), 95))
