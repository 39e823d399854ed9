"""The port's top-level names: every name ``ionotomo_tpu/__init__.py``
re-exports (with the subpackages that importing them binds), the
multi-device ``parallel`` package (``grid_sharding``, ``sharding``) and
``member_parallel_enkf`` included, resolves on ``ionotomo_tpu_torch`` to
the port's own object of that name; and importing the package imports
neither ``jax``, ``ionotomo_tpu`` nor matplotlib (checked in a fresh
interpreter)."""
import importlib
import subprocess
import sys

import ionotomo_tpu
import ionotomo_tpu_torch

MULTI_DEVICE = {"parallel", "grid_sharding", "sharding",
                "member_parallel_enkf"}


def test_every_reference_name_but_the_multi_device_ones_resolves():
    names = [n for n, v in vars(ionotomo_tpu).items()
             if not n.startswith("_")
             and (callable(v) or type(v).__name__ == "module")
             and getattr(v, "__name__", "").split(".")[0] != "jax"]
    assert len(names) > 60
    for name in names:
        ref = getattr(ionotomo_tpu, name)
        got = getattr(ionotomo_tpu_torch, name)
        home = getattr(ref, "__module__", None) or ref.__name__
        port_home = home.replace("ionotomo_tpu", "ionotomo_tpu_torch", 1)
        if type(ref).__name__ == "module":
            assert got is importlib.import_module(port_home), name
        else:
            assert got is getattr(importlib.import_module(port_home),
                                  ref.__name__), name
    assert MULTI_DEVICE <= set(names)


def test_importing_the_port_imports_no_jax_and_no_matplotlib():
    code = ("import sys, ionotomo_tpu_torch; print(sorted({m.split('.')[0] "
            "for m in sys.modules} & {'jax', 'jaxlib', 'ionotomo_tpu', "
            "'matplotlib'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
