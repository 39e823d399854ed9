"""TEC path integrals and the paired differential-TEC forward equation
(port of the parts of ``ionotomo_tpu.forward.tec`` the bent-ray slice
uses).

Units: ray geometry in km, n_e in m^-3; TEC returned in working units of
``constants.TEC_SCALE`` m^-2 (1e13 = 1 mTECU).

The value gathers run through ``core.boxspline.interp_rows`` (kernel K2
on CUDA) and the Hermite endpoint derivatives through
``interp_rows_with_grad`` (kernel K1e on CUDA). The gather is monolithic:
the reference's chunking of large batches bounds a gathered pencil block
that the kernels never build, so it is not ported.

Not ported yet (ROADMAP.md Queue 1 item 7): ``dtec``, ``log_ne_at``,
``tec_linear``, ``tec_linear_adjoint``, ``vtec_map``, ``ray_coverage``,
``dtec_noise_from_beam``, and the cubic/zpc field models.
"""
from __future__ import annotations

import torch

from .. import constants
from ..core import boxspline
from ..core.grids import Grid3D
from ..core.precision import check_full_f32
from ..geometry.fermat import _not_ported, _zp_table
from ..geometry.rays import RayBundle, simpson_weights, trapezoid_weights


def _ref_row(arr: torch.Tensor, i0: int) -> torch.Tensor:
    """arr[i0], the reference antenna's row (unsharded)."""
    return arr[i0]


def _coef2d(field_m: torch.Tensor, grid: Grid3D, interp: str
            ) -> torch.Tensor:
    """The (nx*ny, nz) row-gather table of the zp model: the prefiltered
    box-spline coefficient grid (one matmul + ``order`` 5-point stencil
    passes). Other field models raise NotImplementedError."""
    return _zp_table(field_m, grid, interp)


def _rows_of(interp: str):
    if interp.startswith("zpc"):
        raise _not_ported(interp, "Queue 1 item 12, kernel K6")
    if interp.startswith("zp"):
        return boxspline
    if interp == "cubic":
        raise _not_ported(interp, "Queue 1 item 6, kernel K5")
    raise KeyError(interp)


def _interp_fast(field_m: torch.Tensor, grid: Grid3D, pts2d: torch.Tensor,
                 interp: str = "cubic") -> torch.Tensor:
    """Row-gather interpolation of the log-density at points (N, 3) under
    the selected field model, in one pass over all points."""
    mod = _rows_of(interp)
    table = _coef2d(field_m, grid, interp)
    return mod.interp_rows(table, grid, pts2d)


def ne_at(field_m: torch.Tensor, grid: Grid3D, points: torch.Tensor,
          interp: str = "cubic") -> torch.Tensor:
    """n_e [m^-3] at points (..., 3) from the log-density field m."""
    shape = points.shape[:-1]
    m = _interp_fast(field_m, grid, points.reshape(-1, 3), interp)
    return constants.K_NE * torch.exp(m).reshape(shape)


def tec_from_log_values(m_values: torch.Tensor, rays: RayBundle
                        ) -> torch.Tensor:
    """Simpson TEC quadrature from log-density samples m (R·N,) or (R, N)
    along the bundle."""
    check_full_f32()
    r, n = rays.points.shape[:2]
    ne = constants.K_NE * torch.exp(m_values).reshape(r, n)
    w = simpson_weights(n, ne.dtype, ne.device)
    integral = torch.einsum("rn,n->r", ne, w) * rays.ds * constants.KM_TO_M
    return integral / constants.TEC_SCALE


def dtec_paired_from_log_values(m_values: torch.Tensor, rays: RayBundle,
                                num_directions: int, i0: int = 0
                                ) -> torch.Tensor:
    """Cancellation-free paired-dTEC Simpson quadrature from log-density
    samples: the reference antenna's samples are subtracted sample-wise
    before the reduction."""
    check_full_f32()
    r, n = rays.points.shape[:2]
    na = r // num_directions
    ne = constants.K_NE * torch.exp(m_values).reshape(na, num_directions, n)
    dne = ne - _ref_row(ne, i0)[None, :, :]
    w = simpson_weights(n, ne.dtype, ne.device)
    ds = rays.ds.reshape(na, num_directions)
    out = torch.einsum("akn,n->ak", dne, w) * ds * constants.KM_TO_M
    return out / constants.TEC_SCALE


def tec(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
        interp: str = "cubic") -> torch.Tensor:
    """TEC per ray, (R,), in TEC_SCALE working units (Simpson)."""
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    return tec_from_log_values(m, rays)


def dtec_paired(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
                num_directions: int, i0: int = 0,
                interp: str = "cubic") -> torch.Tensor:
    """Cancellation-free differential TEC (Simpson), (Na, Nd).

    All rays of the engine share one arc-length grid s_n = n·ds per
    direction, so dTEC[i,k] = Σ_n w_n · (n_e(x_{i,k,n}) − n_e(x_{i0,k,n}))
    · ds, valid for bent paths too. ``rays`` is the row-major (antenna ×
    direction) flat batch of ``make_ray_batch``.
    """
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    return dtec_paired_from_log_values(m, rays, num_directions, i0)


def _endpoint_tangents(points: torch.Tensor):
    """(ends (2R,3), unit tangents (2R,3)) at each ray's first and last
    sample, from the first/last path segments."""
    seg0 = points[:, 1] - points[:, 0]
    seg1 = points[:, -1] - points[:, -2]
    t_hat = torch.cat([seg0, seg1], dim=0)
    t_hat = t_hat / torch.linalg.norm(t_hat, dim=-1, keepdim=True)
    ends = torch.cat([points[:, 0], points[:, -1]], dim=0)
    return ends, t_hat


def endpoint_dne_ds_from(m_ends: torch.Tensor, gm_ends: torch.Tensor,
                         t_hat: torch.Tensor):
    """dn_e/ds = K_NE·e^m · (∇m·t̂) [m⁻³/km] at the 2R endpoint samples.
    Returns (d_first (R,), d_last (R,))."""
    check_full_f32()
    r = m_ends.shape[0] // 2
    ne = constants.K_NE * torch.exp(m_ends)
    dnds = ne * torch.einsum("pd,pd->p", gm_ends, t_hat)
    return dnds[:r], dnds[r:]


def tec_hermite_from_values(m_values: torch.Tensor, d0: torch.Tensor,
                            d1: torch.Tensor, rays: RayBundle
                            ) -> torch.Tensor:
    """Hermite TEC quadrature from log-density samples m (R·N,) and the
    n_e path derivatives at the first/last samples (R,) each [m⁻³/km]."""
    check_full_f32()
    r, n = rays.points.shape[:2]
    ne = constants.K_NE * torch.exp(m_values).reshape(r, n)
    w = trapezoid_weights(n, ne.dtype, ne.device)
    integral = (torch.einsum("rn,n->r", ne, w) * rays.ds
                + (d0 - d1) * (rays.ds * rays.ds) / 12.0)
    return integral * (constants.KM_TO_M / constants.TEC_SCALE)


def dtec_paired_hermite_from_values(m_values: torch.Tensor,
                                    d0: torch.Tensor, d1: torch.Tensor,
                                    rays: RayBundle, num_directions: int,
                                    i0: int = 0) -> torch.Tensor:
    """Paired-dTEC twin of ``tec_hermite_from_values`` (sample-wise
    reference-antenna subtraction of values AND endpoint derivatives)."""
    check_full_f32()
    r, n = rays.points.shape[:2]
    na = r // num_directions
    ne = constants.K_NE * torch.exp(m_values).reshape(na, num_directions, n)
    dne = ne - _ref_row(ne, i0)[None, :, :]
    w = trapezoid_weights(n, ne.dtype, ne.device)
    corr = (d0 - d1).reshape(na, num_directions)
    corr = corr - _ref_row(corr, i0)[None, :]
    ds = rays.ds.reshape(na, num_directions)
    out = (torch.einsum("akn,n->ak", dne, w) * ds + corr * ds * ds / 12.0)
    return out * (constants.KM_TO_M / constants.TEC_SCALE)


def _endpoint_dne_ds(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
                     interp: str = "cubic"):
    """Path derivative of n_e at each ray's first and last sample,
    dn_e/ds = n_e · (∇m · t̂), with tangents from the first/last path
    segments. Returns (d_first (R,), d_last (R,)) in m⁻³/km."""
    ends, t_hat = _endpoint_tangents(rays.points)             # (2R, 3)
    m, gm = _rows_of(interp).interp_rows_with_grad(
        _coef2d(field_m, grid, interp), grid, ends)
    return endpoint_dne_ds_from(m, gm, t_hat)


def tec_hermite(field_m: torch.Tensor, grid: Grid3D, rays: RayBundle,
                interp: str = "cubic") -> torch.Tensor:
    """Gradient-augmented (composite cubic-Hermite) TEC per ray, (R,):
    trapezoid values + ds²/12·(f'_first − f'_last)."""
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    d0, d1 = _endpoint_dne_ds(field_m, grid, rays, interp)
    return tec_hermite_from_values(m, d0, d1, rays)


def dtec_paired_hermite(field_m: torch.Tensor, grid: Grid3D,
                        rays: RayBundle, num_directions: int, i0: int = 0,
                        interp: str = "cubic") -> torch.Tensor:
    """Cancellation-free paired dTEC under the Hermite rule, (Na, Nd)."""
    m = _interp_fast(field_m, grid, rays.points.reshape(-1, 3), interp)
    d0, d1 = _endpoint_dne_ds(field_m, grid, rays, interp)
    return dtec_paired_hermite_from_values(m, d0, d1, rays,
                                           num_directions, i0)


def dtec_paired_q(field_m, grid, rays, num_directions, i0=0,
                  quadrature: str = "simpson", interp: str = "cubic"):
    """Paired dTEC under the named quadrature ("simpson" or "hermite")."""
    if quadrature == "hermite":
        return dtec_paired_hermite(field_m, grid, rays, num_directions, i0,
                                   interp)
    if quadrature != "simpson":
        raise ValueError(f"unknown quadrature: {quadrature!r}")
    return dtec_paired(field_m, grid, rays, num_directions, i0, interp)


def tec_q(field_m, grid, rays, quadrature: str = "simpson",
          interp: str = "cubic"):
    """TEC per ray under the named quadrature ("simpson" or "hermite")."""
    if quadrature == "hermite":
        return tec_hermite(field_m, grid, rays, interp)
    if quadrature != "simpson":
        raise ValueError(f"unknown quadrature: {quadrature!r}")
    return tec(field_m, grid, rays, interp)
