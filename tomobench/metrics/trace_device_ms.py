"""trace_device_ms: the card's busy time (the union of every kernel, copy
and fill) over the traces of the profiled block of steady units that
follows the window, ms a trace. What a trace costs the card whatever the
host's pace, which sets the trace's time on the host clock at this
batch."""


def read(name, ctx):
    s = ctx["summary"]
    kind, per = ctx["cell"].layer_unit
    if s is None or kind != "trace" or s.busy_s <= 0:
        return None
    return 1e3 * s.busy_s / (s.n_units * per)
