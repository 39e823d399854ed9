"""The JAX package's eight runnable workflows (``examples/``), on the port.

Each module runs as ``python -m ionotomo_tpu_torch.examples.<name>``
with the reference example's arguments and defaults, plus ``--device``
(the card unless it names another; ``cpu`` runs the plain PyTorch
versions) and ``--no-plots``. Each has ``run(...)``, which returns a dict
of every number the reference example prints, and ``main()``, which
parses the arguments, calls ``run`` and prints the reference's lines.

- ``invert_synthetic``: simulate, invert (MAP Gauss-Newton), plot, and the
  rmse where the Jacobian's sensitivity is high;
- ``kalman_tracking``: the frozen-flow Kalman filter with wind estimation;
- ``bent_retrace``: re-traced bent rays at 30 MHz against the frozen
  linearisation;
- ``uncertainty``: randomise-then-optimise posterior samples and the
  ensemble Kalman filter with inflation;
- ``profile_estimation``: the joint (Chapman θ, δm) solve from slant TEC;
- ``ionosonde_probes``: bottomside soundings, their assimilation and the
  multi-layer joint solve;
- ``real_data_workflow``: h5parm in, curved-Earth anchored inversion, a
  VTEC map out;
- ``sharded_grid``: the bent trace and an LSQR on an x-sharded grid.

Randomness is fed in, as everywhere in the port: each draw the reference
takes from a PRNG key is an argument of ``run`` (standard normals of the
stated shape); when it is absent a CPU ``torch.Generator`` seeded from the
example's constants draws it (``normals``), so a run on the card and one
on the CPU consume the same numbers. The examples' numpy draws are the
reference's own. Matplotlib is imported only when a plot is made.
"""
from __future__ import annotations

import argparse

import torch

from ..data.synth import white_noise
from ..device import as_tensor


def normals(given, shape, seed: int, device) -> torch.Tensor:
    """``given`` (standard normals, numpy or a tensor) on ``device``, or,
    when it is None, ``shape`` standard normals from a CPU
    ``torch.Generator`` seeded with ``seed``."""
    x = (white_noise(shape, seed) if given is None
         else as_tensor(given, device=device))
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"fed-in normals of shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    return x.to(device)


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the options every example takes."""
    ap = argparse.ArgumentParser(
        description=doc.strip().splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda; 'cpu' runs "
                         "the plain PyTorch versions)")
    ap.add_argument("--no-plots", action="store_true",
                    help="write no figure (and import no matplotlib)")
    return ap


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first plot."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt

