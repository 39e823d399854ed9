"""Parametric vertical-profile estimation: the Chapman profile
parameters θ = (log N_peak, h_peak, H) as explicit unknowns of the MAP
solve, jointly with the voxel perturbation field (port of
``ionotomo_tpu.inversion.profile``).

dTEC is blind to the horizontally uniform vertical profile, and VTEC
anchors pin only its column; multi-elevation slant absolute TEC
(``anchors.slant_bundle``) and ionosonde probe rows observe its shape.

    m_total(x) = chapman_log_field(grid; θ) + δm(x)
    minimise ½‖g(θ, δm) − d‖²_{C_d⁻¹} + ½‖δm‖²_{C⁻¹}
             + ½‖θ − θ0‖²_{Σ_θ⁻¹}

by Gauss-Newton with a block-preconditioned model-space CG: the C^{1/2}
substitution of ``solvers.map_gauss_newton`` for δm and the prior std
Σ_θ^{1/2} for θ. The joint system is identity-plus-PSD over (θ, δm),
run by ``core.linalg.cg`` on the flat concatenation [v; u]. Its Jacobian
is J_m(B_θ δθ + δδm), J_m the linearised data operator about the total
field (``PairedDtecLinear`` with the anchor and probe rows) and B_θ the
θ → field Jacobian, taken by ``torch.func.jvp`` and ``torch.func.vjp``
through the closed-form field, where the reference takes
``jax.linearize`` of the whole forward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants
from ..core import linalg
from ..core.grids import Grid3D
from ..models import chapman
from .priors import GPCovariance


class ProfileParams(NamedTuple):
    """Chapman profile parameters as solve unknowns (0-d float32
    tensors). log_n_peak: natural log of N_peak [m⁻³]; h_peak_km,
    scale_km in km."""

    log_n_peak: torch.Tensor
    h_peak_km: torch.Tensor
    scale_km: torch.Tensor

    @staticmethod
    def create(n_peak=1.0e12, h_peak_km=350.0, scale_km=80.0, device=None):
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)
        return ProfileParams(log_n_peak=torch.log(f32(n_peak)),
                             h_peak_km=f32(h_peak_km),
                             scale_km=f32(scale_km))

    @property
    def n_peak(self):
        return torch.exp(self.log_n_peak)


def _altitude(grid: Grid3D, curved: bool) -> torch.Tensor:
    """The altitude the profile is evaluated at: the grid's z axis (flat
    ENU, (nz,)) or each voxel's true altitude above the curved Earth
    ((nx, ny, nz))."""
    if curved:
        return chapman.altitude_field(grid)
    return grid.origin[2] + grid.spacing[2] * torch.arange(
        grid.shape[2], dtype=torch.float32, device=grid.device)


def chapman_log_field(grid: Grid3D, theta: ProfileParams,
                      curved: bool = False) -> torch.Tensor:
    """Log-density field m(x) = log(n_e(x; θ)/K_NE) of the Chapman
    profile, differentiable in θ, floored at ``chapman.M_FLOOR`` as every
    gridded log-field is. ``curved=True`` evaluates it at true altitudes
    above the curved Earth."""
    h = _altitude(grid, curved)
    zt = (h - theta.h_peak_km) / theta.scale_km
    log_ne = theta.log_n_peak + 0.5 * (1.0 - zt - torch.exp(-zt))
    prof = torch.clamp_min(
        log_ne - torch.log(torch.tensor(constants.K_NE, dtype=torch.float32)),
        chapman.M_FLOOR)
    if curved:
        return prof
    return torch.broadcast_to(prof[None, None, :], grid.shape)


def multi_chapman_log_field(grid: Grid3D, theta_arr: torch.Tensor,
                            curved: bool = False) -> torch.Tensor:
    """Multi-layer log-density field from a flat parameter vector
    ``theta_arr`` = (log N₁, h₁, H₁, log N₂, h₂, H₂, …): layers sum in
    density, by logsumexp through the vacuum tails."""
    n_layers = theta_arr.shape[0] // 3
    h = _altitude(grid, curved)
    hh = h if curved else h[None, None, :]
    logs = []
    for i in range(n_layers):
        ln, hp, sc = theta_arr[3 * i], theta_arr[3 * i + 1], \
            theta_arr[3 * i + 2]
        zt = (hh - hp) / sc
        logs.append(ln + 0.5 * (1.0 - zt - torch.exp(-zt)))
    log_ne = torch.logsumexp(torch.stack(logs, dim=0), dim=0)
    prof = torch.clamp_min(
        log_ne - torch.log(torch.tensor(constants.K_NE, dtype=torch.float32)),
        chapman.M_FLOOR)
    return torch.broadcast_to(prof, grid.shape)


class ProfileResult(NamedTuple):
    theta: object              # ProfileParams, or the flat θ vector
    m: torch.Tensor            # full field: build(θ) + δm
    delta_m: torch.Tensor      # voxel perturbation about the profile
    residual_norm: torch.Tensor  # final whitened data residual
    info: tuple                # (residual per step, CG iterations per step)


def map_gauss_newton_profile(grid: Grid3D, rays, d_obs, noise_std, theta0,
                             theta_sigma, cov: GPCovariance,
                             num_directions: int, anchors=None,
                             i0: int = 0, gn_iters: int = 4,
                             cg_iters: int = 20, cg_tol: float = 1e-4,
                             quadrature: str = "hermite",
                             interp: str = "cubic",
                             field_builder=None, probes=None
                             ) -> ProfileResult:
    """Joint MAP over (profile parameters θ, voxel perturbation δm).

    ``theta0``: prior mean of θ (a ``ProfileParams`` for the default
    single flat-Earth Chapman, or a flat vector with ``field_builder``);
    ``theta_sigma``: prior std per parameter, e.g. (0.7, 50.0, 30.0).
    ``anchors`` (``inversion.anchors.TecAnchors``): absolute-TEC rows;
    use multi-elevation slant anchors. ``probes`` (``data.ionosonde.
    NeProbes``): point log-density rows, linear in the total field.
    ``field_builder``: ``theta_arr → log-density field`` (default
    ``chapman_log_field`` on flat Earth). The result's ``theta`` mirrors
    ``theta0``'s form.
    """
    from .solvers import (_dtec_operator, _geometries, _join_anchor_rows,
                          _noise_vector, anchored_forward)

    dev = grid.device
    d_obs = torch.as_tensor(d_obs, dtype=torch.float32, device=dev)
    d = d_obs.reshape(-1)
    cd_diag = _noise_vector(noise_std, d_obs.shape, d) ** 2
    d, cd_diag = _join_anchor_rows(d, cd_diag, anchors, probes)
    inv_cd = 1.0 / cd_diag
    s_theta = torch.as_tensor(theta_sigma, dtype=torch.float32, device=dev)
    as_params = isinstance(theta0, ProfileParams)
    t0 = (torch.stack([theta0.log_n_peak, theta0.h_peak_km,
                       theta0.scale_km]).to(torch.float32).to(dev)
          if as_params else torch.as_tensor(theta0, dtype=torch.float32,
                                            device=dev))
    build = field_builder or (lambda t: chapman_log_field(
        grid, ProfileParams(t[0], t[1], t[2])))
    field_fwd = anchored_forward(grid, rays, num_directions, i0, anchors,
                                 quadrature, probes, interp)
    geos = _geometries(grid, rays, num_directions, i0, anchors, quadrature,
                       interp)
    n_t = t0.shape[0]

    theta_k = t0
    dm_k = torch.zeros(grid.shape, dtype=torch.float32, device=dev)
    res_hist, it_hist = [], []
    for _ in range(gn_iters):
        base, vjp_build = torch.func.vjp(build, theta_k)
        apply_j, apply_jt, g0 = _dtec_operator(
            grid, rays, num_directions, i0, base + dm_k, anchors,
            quadrature=quadrature, probes=probes, interp=interp,
            geometries=geos)

        def jvp(dt, ddm):
            _, b_dt = torch.func.jvp(build, (theta_k,), (dt,))
            return apply_j(b_dt + ddm)

        def vjp(y):
            g = apply_jt(y)
            (gt,) = vjp_build(g)
            return gt, g

        # prior pulls: Δθ = (θ0 − θk) + Σ^{1/2} v, Δδm = −δm_k + C^{1/2} u
        dt_pull = t0 - theta_k
        dm_pull = -dm_k
        r_hat = d - g0 - jvp(dt_pull, dm_pull)

        def matvec(x):
            v, u = x[:n_t], x[n_t:].reshape(grid.shape)
            w = jvp(s_theta * v, cov.apply_sqrt(u)) * inv_cd
            tb, db = vjp(w)
            return torch.cat([v + s_theta * tb,
                              (u + cov.apply_sqrt(db)).reshape(-1)])

        tb0, db0 = vjp(r_hat * inv_cd)
        rhs = torch.cat([s_theta * tb0, cov.apply_sqrt(db0).reshape(-1)])
        x, info = linalg.cg(matvec, rhs, max_iters=cg_iters, tol=cg_tol)
        v, u = x[:n_t], x[n_t:].reshape(grid.shape)
        theta_k = theta_k + dt_pull + s_theta * v
        dm_k = dm_k + dm_pull + cov.apply_sqrt(u)
        res_hist.append(torch.linalg.norm(
            (field_fwd(build(theta_k) + dm_k) - d) / torch.sqrt(cd_diag)))
        it_hist.append(info.iterations)
    theta = (ProfileParams(theta_k[0], theta_k[1], theta_k[2])
             if as_params else theta_k)
    res = torch.stack(res_hist)
    return ProfileResult(theta=theta, m=build(theta_k) + dm_k,
                         delta_m=dm_k, residual_norm=res[-1],
                         info=(res, torch.stack(it_hist)))


def log_profile_rms(m, m_true, grid: Grid3D, floor: float = -4.0
                    ) -> torch.Tensor:
    """Horizontally averaged log-profile rms error: rms over z of the
    difference of horizontal means, where the true profile is populated
    (mean log-density above ``floor``). Measures the component dTEC
    cannot see."""
    prof = torch.mean(torch.as_tensor(m), dim=(0, 1))
    prof_true = torch.mean(torch.as_tensor(m_true), dim=(0, 1))
    mask = prof_true > floor
    e2 = torch.where(mask, (prof - prof_true) ** 2,
                     torch.zeros_like(prof))
    return torch.sqrt(torch.sum(e2) / torch.clamp_min(mask.sum(), 1))
