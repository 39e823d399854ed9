"""Ionospheric Faraday rotation measure along rays (port of
``ionotomo_tpu.forward.rm``).

    RM [rad m^-2] = K_RM ∫ n_e [m^-3] · B_par [T] · ds [m],
    K_RM = e^3 / (2π m_e^2 c^4) ≈ 2.631e-13,

so the polarization angle rotates by RM·λ². The TEC machinery serves it:
n_e at the ray samples is the tricubic row gather (``tec._interp_fast``,
kernel K2 in ray order on CUDA), B comes from any callable on (N, 3) ENU
points (``models.geomagnetic.dipole_b_enu_fn``), evaluated at the same
samples, and the quadrature is the shared Simpson rule. Differential RM
(reference-antenna subtraction) mirrors dTEC.

The gather is on the cubic model whatever model the dTEC of the same
bundle uses, as in the reference, whose ``rotation_measure`` passes no
``interp``: ``predict --interp zp --rm`` gathers RM's n_e through cubic.
"""
from __future__ import annotations

import torch

from .. import constants
from ..core.grids import Grid3D
from ..core.precision import check_full_f32
from ..geometry.rays import RayBundle, simpson_weights
from .tec import _interp_fast, _ref_row

#: e^3 / (2 pi m_e^2 c^4)  [rad m^-2 per (m^-3 · T · m)]
K_RM = 2.631e-13


def _tangents(points: torch.Tensor) -> torch.Tensor:
    """Unit tangent per ray sample from central differences, (R, N, 3).
    Exact for straight rays; 2nd-order along bent paths."""
    fwd = points[:, 1:] - points[:, :-1]
    t = torch.cat([fwd[:, :1], 0.5 * (fwd[:, 1:] + fwd[:, :-1]),
                   fwd[:, -1:]], dim=1)
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                           min=1e-12)


def rotation_measure(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
                     b_enu_fn) -> torch.Tensor:
    """RM per ray, (R,), in rad/m².

    ``b_enu_fn``: (N, 3) ENU km → (N, 3) Tesla on the rays' device (e.g.
    ``models.geomagnetic.dipole_b_enu_fn(array.enu_frame)``).
    """
    check_full_f32()
    r, n = rays.points.shape[:2]
    pts = rays.points.reshape(-1, 3)
    m = _interp_fast(field_m, grid, pts)
    ne = constants.K_NE * torch.exp(m).reshape(r, n)
    b = b_enu_fn(pts).reshape(r, n, 3)
    # astronomical sign convention: B_par along the *propagation*
    # direction (source -> observer), i.e. minus the antenna->sky ray
    # tangent; positive RM = field toward the observer (B points
    # downward at northern latitudes -> ionospheric RM > 0 there)
    b_par = -torch.sum(b * _tangents(rays.points), dim=-1)   # (R, N) [T]
    w = simpson_weights(n, ne.dtype, ne.device)
    integral = torch.einsum("rn,n->r", ne * b_par, w) * rays.ds \
        * constants.KM_TO_M
    return K_RM * integral


def drm(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle, b_enu_fn,
        num_directions: int, i0: int = 0) -> torch.Tensor:
    """Differential RM w.r.t. reference antenna ``i0``, (Na, Nd): the
    Faraday analogue of ``forward.tec.dtec`` (row-major ray batch)."""
    rm = rotation_measure(field_m, grid, rays, b_enu_fn)
    rm = rm.reshape(-1, num_directions)
    return rm - _ref_row(rm, i0)[None, :]
