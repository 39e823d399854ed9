"""launches.<unit>: every kernel, copy and fill the profiler recorded on
the card in the traced sub-window, over its units of work."""
from tomobench.harness.layer import traced


def read(name, ctx):
    t = traced(name, ctx)
    if t is None or not t[0].launches:
        return None
    return t[0].launches / t[1]
