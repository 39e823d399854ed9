"""bent_rays_per_s.<kind>: every ray traced with its TEC in the window over
the window's seconds, on the host clock: the host's pace of the whole
call at this batch, where the card idles most of the time."""


def read(name, ctx):
    rays = ctx["cell"].per_unit.get("bent_ray")
    if not rays:
        return None
    return ctx["units"] * rays / ctx["window"].span
