"""Carry the JAX package's state across to the port.

The engine's "weights" are a grid spec, a log-density field and a prior
covariance; a run's state is a pipeline checkpoint or an online filter's
state. They cross as numpy arrays, so this module needs neither
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


#: The dtypes of an online filter's state (``inversion.online``).
_ONLINE_STATE_DTYPES = {"m": np.float32, "ensemble": np.float32,
                        "t": np.int64, "wind_kmps": np.float64,
                        "dt_s": np.float64, "r_scale": np.float64}


def online_state_from_numpy(state) -> dict:
    """An online filter's ``state_dict`` from the JAX package
    (``OnlineKalman`` or ``OnlineEnsembleKalman``: any mapping whose
    values ``np.asarray`` reads) as the numpy dict the port's
    ``load_state`` takes. The keys are the same in both packages; the
    field or ensemble stays float32 and the scalars keep their float64,
    so the carried state is bit for bit the reference's."""
    return {k: np.asarray(v, _ONLINE_STATE_DTYPES.get(k))
            for k, v in state.items()}


#: The dtypes of a pipeline checkpoint's arrays (``inversion.pipeline``):
#: the fields and residual histories float32, the wind and the noise
#: scale float64, as both packages write them.
_PIPELINE_STATE_DTYPES = {"m_seq": np.float32, "m_std": np.float32,
                          "kalman_pre": np.float32,
                          "kalman_post": np.float32,
                          "enkf_ensemble": np.float32,
                          "enkf_std": np.float32, "wind_kmps": np.float64,
                          "noise_scale": np.float64}


def pipeline_checkpoint_from_numpy(state) -> dict:
    """A batch-inversion checkpoint's state (the JAX package's
    ``InversionPipeline`` or the port's: any mapping whose values
    ``np.asarray`` reads, such as ``utils.checkpoint.load_checkpoint``'s)
    as the numpy dict the port's ``run(resume=True)`` continues from. The
    keys are the same in both packages; unknown keys pass through. With
    its step and config JSON saved by ``utils.checkpoint.save_checkpoint``
    into the run's ``checkpoint_dir``, either package resumes it."""
    return {k: np.asarray(v, _PIPELINE_STATE_DTYPES.get(k))
            for k, v in state.items()}
