"""solve_s: the window's seconds over the solves completed in it."""


def read(name, ctx):
    solves = ctx["cell"].per_unit.get("solve")
    if not solves:
        return None
    return ctx["window"].span / (ctx["units"] * solves)
