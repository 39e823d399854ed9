"""Tomographic inversion solvers (port of ``lsqr_smoothness`` and
``map_gauss_newton`` from ``ionotomo_tpu.inversion.solvers``).

Both are matrix-free over the frozen-path ray operator: the ray samples
stay fixed during a solve and only the field varies. The linearised
operator is ``forward.tec.PairedDtecLinear`` (J and Jᵀ written out; on
CUDA kernels K2, K3, K1e and K1eᵀ), the Krylov loops are
``core.linalg.cg``/``lsqr`` with fixed trip counts and no host sync, and
the prior is ``priors.GPCovariance`` (cuFFT through ``torch.fft``). The
reference's ``jax.lax.scan`` over Gauss-Newton steps is a Python loop.

``map_gauss_newton`` takes ``linearize``, the factory of the linearised
operator (default ``tec.dtec_paired_linear``);
``tec.dtec_paired_linear_ref`` runs the same solve on the plain versions
of the kernels.

Not ported yet: anchor and probe rows (ROADMAP.md Queue 1 item 11,
``inversion/anchors.py``, and item 13, ``data/ionosonde.py``),
``map_gauss_newton_robust``, ``posterior_samples``,
``map_gauss_newton_batched`` and ``steepest_descent_map`` (Queue 1
item 10).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import linalg
from ..core.grids import Grid3D
from ..device import as_tensor
from ..forward import tec as tec_mod
from ..geometry.rays import RayBundle
from .priors import GPCovariance, laplacian


class InversionResult(NamedTuple):
    m: torch.Tensor              # reconstructed log-density field
    residual_norm: torch.Tensor  # ‖W(g(m) − d)‖ final
    info: tuple                  # solver-specific diagnostics
    u_final: torch.Tensor = None  # whitened departure C^{-1/2}(m − m_prior)
                                  # when warm_start=True (carry it into the
                                  # next solve over the same data as u0)


def _extra_rows_not_ported(anchors, probes):
    if anchors is not None:
        raise NotImplementedError(
            "absolute-TEC anchor rows are not ported to ionotomo_tpu_torch "
            "yet (ROADMAP.md Queue 1 item 11, inversion/anchors.py)")
    if probes is not None:
        raise NotImplementedError(
            "point-density probe rows are not ported to ionotomo_tpu_torch "
            "yet (ROADMAP.md Queue 1 item 13, data/ionosonde.py)")


def anchored_forward(grid: Grid3D, rays: RayBundle, num_directions: int,
                     i0: int, anchors=None, quadrature: str = "hermite",
                     probes=None, interp: str = "cubic"):
    """``fwd(m)`` → the flat data vector: the paired dTEC rows. Anchor
    and probe rows raise NotImplementedError."""
    _extra_rows_not_ported(anchors, probes)

    def fwd(m):
        return tec_mod.dtec_paired_q(m, grid, rays, num_directions, i0,
                                     quadrature, interp).reshape(-1)

    return fwd


def _dtec_operator(grid: Grid3D, rays: RayBundle, num_directions: int,
                   i0: int, m0: torch.Tensor, anchors=None,
                   quadrature: str = "hermite", probes=None,
                   interp: str = "cubic", linearize=None):
    """Linearised dTEC operator about m0 and its exact transpose:
    (apply, applyt, g0) with the data space flattened to (Na·Nd,)."""
    _extra_rows_not_ported(anchors, probes)
    op = (linearize or tec_mod.dtec_paired_linear)(
        m0, grid, rays, num_directions, i0, quadrature, interp)
    return op.apply, op.apply_t, op.g0


def _noise_vector(noise_std, shape, like: torch.Tensor) -> torch.Tensor:
    noise = torch.as_tensor(noise_std, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(noise, shape).reshape(-1)


def lsqr_smoothness(grid: Grid3D, rays: RayBundle, d_obs, noise_std, m0,
                    num_directions: int, i0: int = 0, damp: float = 1e-2,
                    smooth: float = 1.0, max_iters: int = 64,
                    quadrature: str = "hermite", interp: str = "cubic"
                    ) -> InversionResult:
    """Config 3: single-snapshot linear inversion with smoothness prior.

    Solves min ‖W(J δm − r)‖² + damp²‖δm‖² + smooth²‖L δm‖² by LSQR on the
    stacked operator [W J; smooth·L; damp·I]. The transpose applies
    ``laplacian`` again as the reference does (it treats L as symmetric).
    d_obs: (Na, Nd) observed dTEC; noise_std broadcastable to it.
    """
    d_obs = torch.as_tensor(d_obs, dtype=torch.float32, device=m0.device)
    w = 1.0 / _noise_vector(noise_std, d_obs.shape, d_obs).clamp_min(1e-12)
    apply_j, apply_jt, g0 = _dtec_operator(grid, rays, num_directions, i0,
                                           m0, quadrature=quadrature,
                                           interp=interp)
    r = (d_obs.reshape(-1) - g0) * w
    nr = r.shape[0]

    def aop(x):
        dm = x.reshape(grid.shape)
        top = apply_j(dm) * w
        mid = smooth * laplacian(dm, grid).reshape(-1)
        return torch.cat([top, mid])

    def atop(y):
        y1 = y[:nr] * w
        y2 = y[nr:].reshape(grid.shape)
        out = apply_jt(y1) + smooth * laplacian(y2, grid)
        return out.reshape(-1)

    zeros = torch.zeros(grid.num_voxels, dtype=r.dtype, device=r.device)
    b = torch.cat([r, zeros])
    dm, info = linalg.lsqr(aop, atop, b, zeros, damp=damp,
                           max_iters=max_iters)
    m = m0 + dm.reshape(grid.shape)
    res = torch.linalg.norm(apply_j(dm.reshape(grid.shape)) * w - r)
    return InversionResult(m=m, residual_norm=res, info=(info,))


def map_gauss_newton(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                     m_prior, cov: GPCovariance, num_directions: int,
                     i0: int = 0, gn_iters: int = 3, cg_iters: int = 40,
                     cg_tol: float = 1e-4, m0=None, anchors=None,
                     quadrature: str = "hermite", probes=None,
                     rays_inner: RayBundle = None, interp: str = "cubic",
                     warm_start: bool = False, u0=None,
                     interp_inner: str = None, linearize=None
                     ) -> InversionResult:
    """Config 4 (and 3b): Bayesian MAP with a GP covariance prior.

    Minimises ½‖g(m)−d‖²_{C_d⁻¹} + ½‖m−m_prior‖²_{C_m⁻¹} by Gauss-Newton
    with C^{1/2}-preconditioned model-space CG: with δm = (m_prior − m_k)
    + C^{1/2} u each inner system is (I + C^{1/2} Jᵀ C_d⁻¹ J C^{1/2}) u =
    rhs, identity plus PSD, and truncated CG iterates are regularised
    steps.

    ``m0``: warm-start iterate (default m_prior; the prior pull stays at
    m_prior). ``rays_inner`` / ``interp_inner``: the linear solve's
    Jacobian (rhs and matvec) from a coarser bundle and/or another zp
    order while residuals stay on ``rays``/``interp`` (mixed-fidelity
    inexact Gauss-Newton). ``warm_start``: carry the whitened CG solution
    u across Gauss-Newton steps (rescaled, ``linalg.cg`` ``scale_x0``);
    ``u0`` carries it between calls over the same data. info is
    (residual per step, CG iterations per step, CG residual per step).
    """
    _extra_rows_not_ported(anchors, probes)
    m_prior = as_tensor(m_prior, device=grid.device)
    d_obs = torch.as_tensor(d_obs, dtype=torch.float32,
                            device=m_prior.device)
    d = d_obs.reshape(-1)
    cd_diag = _noise_vector(noise_std, d_obs.shape, d) ** 2
    inv_cd = 1.0 / cd_diag
    inner_model = interp_inner or interp
    shape = grid.shape

    m_k = m_prior if m0 is None else as_tensor(m0, device=grid.device)
    u = (torch.zeros(m_k.numel(), dtype=torch.float32, device=m_k.device)
         if u0 is None else as_tensor(u0, device=grid.device).reshape(-1))
    res_hist, it_hist, cg_hist = [], [], []
    for _ in range(gn_iters):
        apply_j, apply_jt, g0 = _dtec_operator(
            grid, rays, num_directions, i0, m_k, quadrature=quadrature,
            interp=interp, linearize=linearize)
        if rays_inner is not None or inner_model != interp:
            apply_jc, apply_jtc, _ = _dtec_operator(
                grid, rays_inner if rays_inner is not None else rays,
                num_directions, i0, m_k, quadrature=quadrature,
                interp=inner_model, linearize=linearize)
        else:
            apply_jc, apply_jtc = apply_j, apply_jt
        dm_prior = m_prior - m_k
        r_hat = d - g0 - apply_j(dm_prior)     # residual after prior pull

        def matvec(x):
            v = cov.apply_sqrt(x.reshape(shape))
            w = apply_jc(v) * inv_cd
            z = cov.apply_sqrt(apply_jtc(w))
            return x + z.reshape(-1)

        rhs = cov.apply_sqrt(apply_jtc(r_hat * inv_cd)).reshape(-1)
        u, info = linalg.cg(matvec, rhs, x0=(u if warm_start else None),
                            max_iters=cg_iters, tol=cg_tol,
                            scale_x0=warm_start)
        dm = dm_prior + cov.apply_sqrt(u.reshape(shape))
        m_k = m_k + dm
        res_hist.append(torch.linalg.norm((g0 + apply_j(dm) - d)
                                          / torch.sqrt(cd_diag)))
        it_hist.append(info.iterations)
        cg_hist.append(info.residual_norm)
    res = torch.stack(res_hist)
    return InversionResult(
        m=m_k, residual_norm=res[-1],
        info=(res, torch.stack(it_hist), torch.stack(cg_hist)),
        u_final=(u if warm_start else None))
