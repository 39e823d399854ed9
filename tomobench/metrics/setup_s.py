"""setup_s: process start to the first timed unit (imports, library load
and build, the world, the warm-up), host clock."""


def read(name, ctx):
    return ctx["setup_s"]
