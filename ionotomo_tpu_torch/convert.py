"""Carry the JAX package's state across to the port.

The engine's "weights" are a grid spec, a log-density field and a prior
covariance. They cross as numpy arrays, so this module needs neither
package's arrays to be of any particular type: anything ``np.asarray``
reads will do. They land on the card unless ``device`` names another
(``device.resolve``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.grids import Grid3D
from .device import resolve
from .inversion.priors import GPCovariance
from .models.turbulence import FourierModes


def grid_from_numpy(origin, spacing=None, shape=None, device=None) -> Grid3D:
    """A port ``Grid3D`` from (origin, spacing, shape), or from any object
    with ``origin``/``spacing``/``shape`` attributes (the JAX package's
    ``Grid3D`` among them) passed as the first argument."""
    if spacing is None and shape is None and hasattr(origin, "spacing"):
        origin, spacing, shape = origin.origin, origin.spacing, origin.shape
    if spacing is None or shape is None:
        raise TypeError("grid_from_numpy needs origin, spacing and shape, "
                        "or one object that has all three")
    return Grid3D.create(np.asarray(origin, np.float32),
                         np.asarray(spacing, np.float32), shape,
                         device=device)


def field_from_numpy(m, device=None) -> torch.Tensor:
    """A field (e.g. the log-density m) as a contiguous float32 tensor."""
    return torch.tensor(np.asarray(m, np.float32), device=resolve(device))


def gp_covariance_from_numpy(cov, device=None) -> GPCovariance:
    """A port ``GPCovariance`` from any object with its ``spectrum`` (read
    as numpy) and meta fields ``shape``, ``sigma``, ``length_scale`` and
    ``kind`` (the JAX package's ``GPCovariance`` among them)."""
    ls = cov.length_scale
    return GPCovariance(
        spectrum=torch.tensor(np.asarray(cov.spectrum, np.float32),
                              device=resolve(device)),
        shape=tuple(int(s) for s in cov.shape), sigma=float(cov.sigma),
        length_scale=(tuple(float(v) for v in ls)
                      if isinstance(ls, (tuple, list)) else float(ls)),
        kind=str(cov.kind))


def fourier_modes_from_numpy(ks, phases, amp, device=None) -> FourierModes:
    """A port ``FourierModes`` from its arrays: ks (K, 3), phases (K,) and
    the amplitude."""
    return FourierModes.from_arrays(field_from_numpy(ks, device),
                                    field_from_numpy(phases, device),
                                    float(amp))
