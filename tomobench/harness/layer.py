"""What the per-layer readers share: the traced sub-window of a run whose
cell counts the metric's unit of work (the part of its name after the
dot), and how many of those units it ran."""


def traced(name, ctx):
    """(the trace summary, units of the metric's kind in it), or None
    where the cell's driver does not count that unit or nothing was
    traced."""
    s = ctx["summary"]
    kind, per = ctx["cell"].layer_unit
    if s is None or name.split(".", 1)[-1] != kind:
        return None
    return s, s.n_units * per
