"""Absolute-TEC anchoring: lift dTEC's common-mode null space (port of
``ionotomo_tpu.inversion.anchors``).

Differential TEC is blind to any field change that adds the same TEC to
every ray of an antenna, in practice the common-mode vertical profile.
Calibration pipelines close this gap with external **absolute** TEC
(GNSS-derived vertical-TEC maps over the array). This module represents
such data as extra absolute-TEC rows: an anchor is a ray (usually a
vertical column) with an observed TEC value and a noise level. The MAP
solver fits them jointly with the dTEC rows
(``solvers.map_gauss_newton(..., anchors=...)``), and the functions here
assimilate them on their own, into a prior mean or an ensemble.

Typical use::

    bundle = vertical_anchor_bundle(grid)                   # (A, N, 3)
    anchors = TecAnchors(bundle, vtec_obs, noise)           # external data
    res = solvers.map_gauss_newton(..., anchors=anchors)

The updates take ``linearize``, a function m → the linearised observation
operator about m (``g0``, ``apply``, ``apply_t``:
``forward.tec.tec_linear_op`` for anchors, ``forward.tec.LogNeLinear`` for
point-density probes), where the reference takes ``jax.linearize`` of a
forward function. Fields may carry a leading member axis: the solves of
all members run as one batched CG (``core.linalg.cg(batch_dims=1)``) over
kernels K2b and K3b.

Randomness is fed in: ``anchors_from_field`` takes its unit-normal draws.

The reference's ``member_axis`` (its pmean of the ensemble mean inside
``inversion/kalman.py:member_parallel_enkf``) is the square-root updates'
``mean=``: the member-parallel filter passes each group the whole
ensemble's mean.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants
from ..core import linalg
from ..core.grids import Grid3D
from ..forward import tec as tec_mod
from ..geometry.rays import RayBundle
from .priors import GPCovariance


class TecAnchors(NamedTuple):
    """Absolute-TEC constraints: ``values[a] ≈ ∫ n_e ds`` over
    ``rays.points[a]`` (TEC_SCALE working units), weighted by
    ``noise_std`` (scalar or (A,))."""

    rays: RayBundle
    values: torch.Tensor
    noise_std: torch.Tensor


def _bundle(pts: np.ndarray, ds: np.ndarray, device) -> RayBundle:
    return RayBundle(
        points=torch.as_tensor(pts.astype(np.float32), device=device),
        ds=torch.as_tensor(ds.astype(np.float32), device=device))


def _grid_numpy(grid: Grid3D):
    """(origin, span) of the grid as float64 numpy (a host read: set-up
    only)."""
    origin = grid.origin.cpu().numpy().astype(np.float64)
    spacing = grid.spacing.cpu().numpy().astype(np.float64)
    return origin, spacing * (np.asarray(grid.shape) - 1)


def columns_bundle(grid: Grid3D, points_xy, n_samples: int = 65
                   ) -> RayBundle:
    """Vertical columns through the grid's full z extent at the given
    horizontal ENU positions (A, 2) [km]: anchor geometry for a VTEC map
    sampled at arbitrary pierce points. On the grid's device."""
    xy = np.atleast_2d(np.asarray(points_xy, np.float64))
    origin = grid.origin.cpu().numpy().astype(np.float64)
    span_z = float(grid.spacing[2]) * (grid.shape[2] - 1)
    a = xy.shape[0]
    s = np.linspace(0.0, span_z, n_samples)
    pts = np.concatenate(
        [np.broadcast_to(xy[:, None, :], (a, n_samples, 2)),
         np.broadcast_to((origin[2] + s)[None, :, None],
                         (a, n_samples, 1))], axis=-1)
    ds = np.full((a,), span_z / (n_samples - 1), np.float32)
    return _bundle(pts, ds, grid.device)


def slant_bundle(grid: Grid3D, points_xy, az_rad, el_rad,
                 n_samples: int = 65) -> RayBundle:
    """Slant anchor rays, the geometry of GNSS observations: receiver at
    ENU ``points_xy`` (A, 2) on the grid floor, looking along (azimuth
    from North through East, elevation) [rad; broadcast to A], sampled
    until the path exits the grid top. Pass the raw slant TEC as the
    anchor value (the 3-D operator is the mapping function).

    Elevations below 10° are rejected: the ray would run hundreds of km
    horizontally, far past the grid's edge, where the edge clamp would
    silently extrapolate boundary values into the integral."""
    xy = np.atleast_2d(np.asarray(points_xy, np.float64))
    a = xy.shape[0]
    az = np.broadcast_to(np.asarray(az_rad, np.float64), (a,))
    el = np.broadcast_to(np.asarray(el_rad, np.float64), (a,))
    if np.any(el < np.deg2rad(10.0)):
        raise ValueError(
            "slant_bundle: elevation below 10 deg (min given: "
            f"{np.degrees(el.min()):.1f}); such rays leave the grid "
            "horizontally and the edge-clamped integral would be biased")
    d = np.stack([np.cos(el) * np.sin(az), np.cos(el) * np.cos(az),
                  np.sin(el)], axis=-1)
    origin = grid.origin.cpu().numpy().astype(np.float64)
    span_z = float(grid.spacing[2]) * (grid.shape[2] - 1)
    length = span_z / np.sin(el)                    # exit at grid top
    o3 = np.concatenate([xy, np.full((a, 1), origin[2])], axis=-1)
    s = np.linspace(0.0, 1.0, n_samples)
    pts = o3[:, None, :] + (length[:, None, None] * s[None, :, None]
                            * d[:, None, :])
    ds = (length / (n_samples - 1)).astype(np.float32)
    return _bundle(pts, ds, grid.device)


def thin_shell_mapping(el_rad, h_shell_km: float = 350.0,
                       earth_radius_km: float = 6371.0):
    """Standard single-layer mapping function M(el) = STEC/VTEC for a thin
    shell at ``h_shell_km``: 1/cos(z') with sin z' = R cos(el)/(R+h)."""
    el = np.asarray(el_rad, np.float64)
    sz = earth_radius_km * np.cos(el) / (earth_radius_km + h_shell_km)
    return 1.0 / np.sqrt(1.0 - sz * sz)


def vertical_anchor_bundle(grid: Grid3D, nx: int = 4, ny: int = 4,
                           n_samples: int = 65,
                           margin_frac: float = 0.12) -> RayBundle:
    """Vertical columns through the grid at an nx×ny horizontal lattice
    (inset by ``margin_frac`` of the extent, away from the edge clamp),
    spanning the full z extent: the geometry of a GNSS VTEC map sampled
    over the array."""
    origin, span = _grid_numpy(grid)
    xs = origin[0] + span[0] * np.linspace(margin_frac, 1 - margin_frac, nx)
    ys = origin[1] + span[1] * np.linspace(margin_frac, 1 - margin_frac, ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    xy = np.stack([X.ravel(), Y.ravel()], axis=-1)
    return columns_bundle(grid, xy, n_samples)


def anchors_from_npz(grid: Grid3D, path, n_samples: int = 65
                     ) -> TecAnchors:
    """Build vertical-column anchors from the CLI npz format
    (``points_xy`` (A,2) ENU km, ``values_tecu`` (A,), ``noise_tecu``
    scalar). Pierce points must lie inside the grid's horizontal extent:
    columns outside would be silently edge-clamped and bias every
    solve."""
    with np.load(path) as z:
        xy = np.asarray(z["points_xy"], np.float64)
        v = (np.asarray(z["values_tecu"], np.float64)
             * constants.TECU / constants.TEC_SCALE)
        noise = (float(z["noise_tecu"]) * constants.TECU
                 / constants.TEC_SCALE)
    origin, span = _grid_numpy(grid)
    bad = ((xy[:, 0] < origin[0]) | (xy[:, 0] > origin[0] + span[0])
           | (xy[:, 1] < origin[1]) | (xy[:, 1] > origin[1] + span[1]))
    if bad.any():
        raise ValueError(
            f"{int(bad.sum())} anchor pierce point(s) fall outside the "
            f"grid's horizontal extent x∈[{origin[0]:.0f}, "
            f"{origin[0]+span[0]:.0f}], y∈[{origin[1]:.0f}, "
            f"{origin[1]+span[1]:.0f}] km — out-of-grid columns would be "
            "edge-clamped and bias the solve; drop them or enlarge the "
            "grid")
    dev = grid.device
    return TecAnchors(rays=columns_bundle(grid, xy, n_samples),
                      values=torch.as_tensor(v.astype(np.float32),
                                             device=dev),
                      noise_std=torch.tensor(noise, dtype=torch.float32,
                                             device=dev))


def background_covariance(grid: Grid3D, sigma: float = 1.0,
                          vertical_scale_km: float = 150.0) -> GPCovariance:
    """Background-error covariance for sequential anchor assimilation:
    long horizontal correlation (half the grid's horizontal span: profile
    errors are large-scale) × ``vertical_scale_km``. Distinct from the
    turbulence prior."""
    _, span = _grid_numpy(grid)
    l_h = 0.5 * float(max(span[0], span[1]))
    return GPCovariance.create(grid, sigma=sigma,
                               length_scale=(l_h, l_h, vertical_scale_km),
                               kind="sqexp")


def inv_variance(noise_std, values: torch.Tensor) -> torch.Tensor:
    """1/σ² per row, (A,), from a scalar or per-row noise level."""
    noise = torch.as_tensor(noise_std, dtype=values.dtype,
                            device=values.device)
    return 1.0 / torch.broadcast_to(noise, values.shape[-1:]).reshape(-1) ** 2


def whitened_gain(cov: GPCovariance, op, r: torch.Tensor, inv_cd,
                  cg_iters: int, cg_tol: float) -> torch.Tensor:
    """K r for the gain K = C Jᵀ (J C Jᵀ + C_d)⁻¹ of the operator ``op``
    (J = ``op.apply``), matrix-free: C^{1/2} u with u the truncated-CG
    solution of the identity-plus-PSD system
    (I + C^{1/2} Jᵀ C_d⁻¹ J C^{1/2}) u = C^{1/2} Jᵀ C_d⁻¹ r. ``r`` (...,
    rows) may carry one leading member axis; the systems are then solved
    at once, each masked on its own."""
    def matvec(u):
        z = op.apply_t(op.apply(cov.apply_sqrt(u)) * inv_cd)
        return u + cov.apply_sqrt(z)

    rhs = cov.apply_sqrt(op.apply_t(r * inv_cd))
    u, _ = linalg.cg(matvec, rhs, max_iters=cg_iters, tol=cg_tol,
                     batch_dims=rhs.dim() - 3)
    return cov.apply_sqrt(u)


def linear_map_step(grid: Grid3D, m_k: torch.Tensor, cov: GPCovariance,
                    linearize, values, inv_cd, cg_iters: int,
                    cg_tol: float = 1e-5, m_pull=None) -> torch.Tensor:
    """One Gauss-Newton step of a MAP update about ``m_k`` for an
    arbitrary field→data observation operator
    (C^{1/2}-preconditioned CG, as in ``solvers.map_gauss_newton``), with
    the prior pull anchored at ``m_pull`` (None: pull at ``m_k`` itself,
    the pure regularised update used per filter step). ``linearize(m)``
    gives the operator about m. ``m_k`` (B, ...) with ``values`` (B, A)
    updates B members at once."""
    op = linearize(m_k)
    r_lin = values - op.g0
    dm_prior = 0.0
    if m_pull is not None:
        dm_prior = m_pull - m_k
        r_lin = r_lin - op.apply(dm_prior)
    return m_k + dm_prior + whitened_gain(cov, op, r_lin, inv_cd, cg_iters,
                                          cg_tol)


def _tec_linearize(grid, rays, quadrature, interp, geometry=None):
    if geometry is None:
        geometry = tec_mod.dtec_geometry(grid, rays, None, None, quadrature,
                                         interp)
    return lambda m: tec_mod.tec_linear_op(m, grid, rays, quadrature, interp,
                                           geometry)


def anchor_map_step(grid: Grid3D, m_k: torch.Tensor, cov: GPCovariance,
                    rays: RayBundle, values, inv_cd, cg_iters: int,
                    cg_tol: float = 1e-5, m_pull=None,
                    quadrature: str = "simpson", interp: str = "cubic",
                    geometry=None) -> torch.Tensor:
    """Anchors-only MAP step: ``linear_map_step`` with the absolute-TEC
    operator. ``quadrature``/``interp`` select the operator
    discretisation the run's solvers use, so anchor rows are fitted with
    the same discretisation as the dTEC rows. ``geometry``: the anchor
    rays' ``forward.tec.DtecGeometry`` when the caller keeps one (a
    filter anchors every step over the same rays)."""
    return linear_map_step(grid, m_k, cov,
                           _tec_linearize(grid, rays, quadrature, interp,
                                          geometry),
                           values, inv_cd, cg_iters, cg_tol, m_pull)


def linear_sqrt_update(grid: Grid3D, ens: torch.Tensor, cov: GPCovariance,
                       linearize, values, inv_cd, cg_iters: int,
                       cg_tol: float = 1e-5, mean=None) -> torch.Tensor:
    """Deterministic (square-root / ensemble-adjustment) update of an
    ensemble (B, ...) for any linearisable observation operator.

    With the fixed background-error covariance B (``cov``) and the
    operator H linearised at the ensemble mean, the gain
    K = B Hᵀ (H B Hᵀ + R)⁻¹ is applied matrix-free:

      mean:      m̄ ← m̄ + K (y − H m̄)           (unperturbed values)
      anomalies: δᵢ ← (I − K H) δᵢ = δᵢ + K(0 − H δᵢ)

    For tiny ensembles this removes the O(1/√n) sampling noise the
    stochastic perturbed-observation update injects through K εᵢ. The
    B + 1 gain applications (the mean's and the anomalies') are one
    batched CG. Returns the updated ensemble.

    ``mean``: the whole ensemble's mean when ``ens`` is one group of a
    member-parallel ensemble (``kalman.member_parallel_enkf``; the
    reference's pmean under ``member_axis``): every group then linearises
    at it and updates it alike, beside its own anomalies."""
    m_bar = ens.mean(0) if mean is None else mean
    op = linearize(m_bar)
    d = ens - m_bar[None]
    r = torch.cat([(values - op.g0)[None], -op.apply(d)])
    k_r = whitened_gain(cov, op, r, inv_cd, cg_iters, cg_tol)
    return (m_bar + k_r[0])[None] + (d + k_r[1:])


def anchor_sqrt_update(grid: Grid3D, ens: torch.Tensor, cov: GPCovariance,
                       rays: RayBundle, values, inv_cd, cg_iters: int,
                       cg_tol: float = 1e-5, quadrature: str = "simpson",
                       interp: str = "cubic", geometry=None,
                       mean=None) -> torch.Tensor:
    """Square-root anchored ensemble update: ``linear_sqrt_update`` with
    the absolute-TEC operator (``mean``: see there)."""
    return linear_sqrt_update(grid, ens, cov,
                              _tec_linearize(grid, rays, quadrature, interp,
                                             geometry),
                              values, inv_cd, cg_iters, cg_tol, mean)


def _probe_setup(grid, probes, cov, interp):
    if cov is None:
        cov = background_covariance(grid, vertical_scale_km=80.0)
    values = torch.as_tensor(probes.values, dtype=torch.float32,
                             device=grid.device).reshape(-1)
    noise = torch.as_tensor(probes.noise_std, dtype=torch.float32,
                            device=grid.device)
    inv_cd = 1.0 / torch.broadcast_to(noise, probes.values.shape
                                      ).reshape(-1) ** 2
    points = torch.as_tensor(probes.points, dtype=torch.float32,
                             device=grid.device).reshape(-1, 3)
    return cov, values, inv_cd, lambda m: tec_mod.LogNeLinear(m, grid, points,
                                                              interp)


def probe_sqrt_update(grid: Grid3D, ens: torch.Tensor, probes, cov=None,
                      cg_iters: int = 30, cg_tol: float = 1e-5,
                      interp: str = "cubic") -> torch.Tensor:
    """Square-root ensemble update from point-density probes (any object
    with ``points`` (P, 3), ``values`` (P,) log-densities and
    ``noise_std``): the ensemble analogue of ``assimilate_probes``.
    ``cov`` defaults to the probe-specific short-vertical background
    covariance (~80 km vertical; see ``assimilate_probes``)."""
    cov, values, inv_cd, linearize = _probe_setup(grid, probes, cov, interp)
    return linear_sqrt_update(grid, ens, cov, linearize, values, inv_cd,
                              cg_iters, cg_tol)


def assimilate_anchors(grid: Grid3D, m_prior: torch.Tensor,
                       cov: GPCovariance, anchors: TecAnchors,
                       gn_iters: int = 2, cg_iters: int = 30,
                       cg_tol: float = 1e-5, quadrature: str = "simpson",
                       interp: str = "cubic") -> torch.Tensor:
    """MAP-update the prior mean from the absolute-TEC anchors alone.

    Sequential assimilation: the anchor rows are few and observe mostly
    the common-mode/profile component that the dTEC rows cannot see, so
    assimilating them first, producing a corrected background that the
    dTEC solve then uses as its prior mean, sidesteps the truncated-CG
    direction competition of a joint solve. The posterior covariance is
    approximated by the prior. The prior pull stays anchored at
    ``m_prior`` over the Gauss-Newton steps."""
    values = anchors.values
    inv_cd = inv_variance(anchors.noise_std, values)
    geometry = tec_mod.dtec_geometry(grid, anchors.rays, None, None,
                                     quadrature, interp)
    m = m_prior
    for _ in range(gn_iters):
        m = anchor_map_step(grid, m, cov, anchors.rays, values, inv_cd,
                            cg_iters, cg_tol, m_pull=m_prior,
                            quadrature=quadrature, interp=interp,
                            geometry=geometry)
    return m


def assimilate_probes(grid: Grid3D, m_prior: torch.Tensor, probes,
                      cov=None, gn_iters: int = 2, cg_iters: int = 30,
                      cg_tol: float = 1e-5, interp: str = "cubic"
                      ) -> torch.Tensor:
    """MAP-update the prior mean from point-density probes alone
    (ionosonde bottomside soundings). The observation is exactly linear
    in m, so one Gauss-Newton step is exact up to CG truncation;
    ``gn_iters`` > 1 polishes the truncation.

    ``cov`` (None: ``background_covariance(grid, vertical_scale_km=80)``):
    long horizontal correlation, since a few sounder columns must correct
    the profile across the whole grid, but a short vertical scale of about
    one scale height: profile-error corrections flip sign across it."""
    cov, values, inv_cd, linearize = _probe_setup(grid, probes, cov, interp)
    m = m_prior
    for _ in range(gn_iters):
        m = linear_map_step(grid, m, cov, linearize, values, inv_cd,
                            cg_iters, cg_tol, m_pull=m_prior)
    return m


def anchors_from_field(field_m: torch.Tensor, grid: Grid3D,
                       bundle: RayBundle, noise_std: float,
                       noise=None) -> TecAnchors:
    """Simulate the external absolute-TEC instrument from a (truth) field:
    values = TEC over the anchor rays + ``noise_std`` · ``noise``, the
    caller's unit-normal draws (A,) (None: noise-free values). Test and
    benchmark helper; real data enters through ``TecAnchors`` directly."""
    v = tec_mod.tec(field_m, grid, bundle)
    if noise is not None:
        v = v + noise_std * torch.as_tensor(noise, dtype=v.dtype,
                                            device=v.device)
    return TecAnchors(rays=bundle, values=v,
                      noise_std=torch.tensor(noise_std, dtype=torch.float32,
                                             device=v.device))
