"""Directional phase screens: per-antenna GP interpolation of dTEC over
the sky (port of ``ionotomo_tpu.inversion.screens``).

Given a DataPack timestep, fits an independent GP per antenna over
tangent-plane sky coordinates and predicts dTEC (hence dispersive phase)
at arbitrary directions: the calibration-screen product. All antennas
share the input locations, so the fits are one Cholesky solve with the
antennas as right-hand sides, on ``device`` (the card unless named).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.precision import check_full_f32
from ..device import host, resolve
from ..utils import gaussian_process as gp


class Screen(NamedTuple):
    """Fitted per-antenna sky screens at one timestep."""

    x: torch.Tensor        # (Nd, 2) tangent-plane coords of fit directions
    alpha: torch.Tensor    # (Na, Nd) Cholesky-solved weights per antenna
    chol: torch.Tensor     # (Nd, Nd) shared Cholesky factor
    center: np.ndarray     # (2,) ra/dec of the tangent point
    kernel: object
    noise_std: float


def _tangent_plane(radec, center):
    ra0, dec0 = center
    x = (radec[..., 0] - ra0) * np.cos(dec0)
    y = radec[..., 1] - dec0
    return np.stack([x, y], axis=-1)


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def _default_kernel(x: torch.Tensor, d: torch.Tensor):
    """A squared exponential with the data's (population) std and half the
    directions' spread as its length scale."""
    spread = float(np.abs(host(x)).max()) or 1.0
    return gp.SquaredExponential(
        sigma=float(torch.std(d, correction=0)) + 1e-6,
        length_scale=0.5 * spread)


def fit_screen(datapack, time_idx=0, kernel=None, noise_std=None,
               device=None) -> Screen:
    """Fit GP screens to dtec[:, time_idx, :] for every antenna at once."""
    dev = resolve(device)
    radec = datapack.directions
    center = radec.mean(axis=0)
    x = _f32(_tangent_plane(radec, center), dev)
    d = _f32(datapack.dtec[:, time_idx, :], dev)              # (Na, Nd)
    if noise_std is None:
        noise_std = float(np.median(datapack.noise_std[:, time_idx, :]))
    if kernel is None:
        kernel = _default_kernel(x, d)

    k = kernel(x, x) + (noise_std**2) * torch.eye(x.shape[0], device=dev)
    alpha, chol = gp.cho_solve_stack(k, d.T)                  # (Nd, Na)
    return Screen(x=x, alpha=alpha.T, chol=chol, center=center,
                  kernel=kernel, noise_std=noise_std)


def predict_screen(screen: Screen, radec_query):
    """Predict dTEC for every antenna at query directions.

    Returns (mean (Na, M), var (M,)): the variance is antenna-independent
    because all antennas share locations and kernel.
    """
    check_full_f32()
    xq = _f32(_tangent_plane(np.atleast_2d(radec_query), screen.center),
              screen.x.device)
    ks = screen.kernel(screen.x, xq)                  # (Nd, M)
    mean = screen.alpha @ ks                          # (Na, M)
    v = torch.linalg.solve_triangular(screen.chol, ks, upper=False)
    var = torch.clamp(torch.diagonal(screen.kernel(xq, xq))
                      - torch.sum(v * v, dim=0), min=0.0)
    return mean, var


def fit_screen_hyperparameters(datapack, time_idx=0, antenna=None,
                               steps=150, device=None):
    """Maximise the marginal likelihood of the screen kernel on one
    antenna's data (or the antenna with the strongest signal) and return
    the fitted kernel for reuse in fit_screen."""
    dev = resolve(device)
    d = np.asarray(datapack.dtec[:, time_idx, :])
    if antenna is None:
        antenna = int(np.argmax(np.abs(d).std(axis=1)))
    radec = datapack.directions
    x = _f32(_tangent_plane(radec, radec.mean(axis=0)), dev)
    y = _f32(d[antenna], dev)
    noise = float(np.median(datapack.noise_std[antenna, time_idx, :]))
    fitted, _ = gp.fit_hyperparameters(_default_kernel(x, y), x, y, noise,
                                       steps=steps)
    return fitted
