"""Tomographic inversion solvers (port of
``ionotomo_tpu.inversion.solvers``).

All are matrix-free over the frozen-path ray operator: the ray samples
stay fixed during a solve and only the field varies. The linearised
operator is ``forward.tec.PairedDtecLinear`` (J and Jᵀ written out; on
CUDA kernels K2 and K3 with K5 and K5ᵀ on the default tricubic model, or
K1e and K1eᵀ on zp; K2b and K3b over a member axis), the Krylov loops
are ``core.linalg.cg``/``lsqr`` with fixed trip counts and no host sync,
and the prior is ``priors.GPCovariance`` (cuFFT through ``torch.fft``).
The reference's ``jax.lax.scan`` loops (Gauss-Newton steps, IRLS rounds,
descent iterations) are Python loops, and its ``jax.vmap`` over draws or
line-search steps is a leading member axis.

- ``lsqr_smoothness``: config 3, LSQR with a smoothness prior.
- ``map_gauss_newton``: config 4 (and 3b), Bayesian MAP by Gauss-Newton
  with C^{1/2}-preconditioned CG. The geometry of its bundle (point
  set-up, scatter plans, point order) is built once a call and shared by
  its Gauss-Newton steps.
- ``map_gauss_newton_robust``: Huber IRLS rounds of ``map_gauss_newton``.
- ``posterior_samples``: randomise-then-optimise draws, all of them one
  batched CG (``batch_dims=1``) over the operator's member axis; the
  draws are fed in.
- ``map_gauss_newton_batched``: independent snapshots, one
  ``map_gauss_newton`` each (each epoch carries its own rays).
- ``steepest_descent_map``: the reference's own covariance-preconditioned
  descent with a grid line search, its objectives one member axis.

``map_gauss_newton`` takes ``linearize``, the factory of the linearised
operator (default ``tec.dtec_paired_linear``);
``tec.dtec_paired_linear_ref`` runs the same solve on the plain versions
of the kernels. It also takes absolute-TEC anchor rows
(``inversion.anchors.TecAnchors``) and point-density probe rows (any
object with ``points``, ``values``, ``noise_std``) appended to the data
vector in the order [dTEC, anchors, probes].
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


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1)


def anchored_forward(grid: Grid3D, rays: RayBundle, num_directions: int,
                     i0: int, anchors=None, quadrature: str = "hermite",
                     probes=None, interp: str = "cubic"):
    """``fwd(m)`` → the stacked flat data vector: the paired dTEC rows,
    then the absolute-TEC anchor rows (``inversion.anchors.TecAnchors``),
    then the point-density probe rows (any object with ``points``,
    ``values``, ``noise_std``; linear in m). Row order [dTEC, anchors,
    probes], as ``_join_anchor_rows`` appends them."""

    def fwd(m):
        rows = [_flat(tec_mod.dtec_paired_q(m, grid, rays, num_directions,
                                            i0, quadrature, interp))]
        if anchors is not None:
            rows.append(tec_mod.tec_q(m, grid, anchors.rays, quadrature,
                                      interp))
        if probes is not None:
            rows.append(_flat(tec_mod.log_ne_at(m, grid, probes.points,
                                                interp)))
        return rows[0] if len(rows) == 1 else torch.cat(rows)

    return fwd


class _StackedRows:
    """Linear operators over one field stacked along the data axis:
    ``apply`` concatenates their rows, ``apply_t`` sums their transposes.
    Tangents and cotangents may carry leading member axes (the operators
    are linearised about one field)."""

    def __init__(self, ops):
        self.ops = ops
        self.sizes = [op.g0.numel() for op in ops]
        self.g0 = torch.cat([_flat(op.g0) for op in ops])

    def apply(self, dm):
        lead = dm.shape[:-3]
        return torch.cat([op.apply(dm).reshape(lead + (-1,))
                          for op in self.ops], dim=-1)

    def apply_t(self, y):
        lead = y.shape[:-1]
        parts = torch.split(y, self.sizes, dim=-1)
        out = None
        for op, part in zip(self.ops, parts):
            t = op.apply_t(part.reshape(lead + tuple(op.g0.shape)))
            out = t if out is None else out + t
        return out


class _SolveGeometries(NamedTuple):
    """The geometries of a solve's bundle and of its anchor rays: what
    every linearisation over them shares (``tec.DtecGeometry``)."""
    rays: object
    anchors: object


def _geometries(grid: Grid3D, rays: RayBundle, num_directions: int, i0: int,
                anchors=None, quadrature: str = "hermite",
                interp: str = "cubic", linearize=None) -> _SolveGeometries:
    """Build the geometries once for a solve's linearisations (the plain
    operators take no plans)."""
    plans = linearize is not tec_mod.dtec_paired_linear_ref
    return _SolveGeometries(
        tec_mod.dtec_geometry(grid, rays, num_directions, i0, quadrature,
                              interp, plans),
        None if anchors is None else tec_mod.dtec_geometry(
            grid, anchors.rays, None, None, quadrature, interp, plans))


def _dtec_operator(grid: Grid3D, rays: RayBundle, num_directions: int,
                   i0: int, m0: torch.Tensor, anchors=None,
                   quadrature: str = "hermite", probes=None,
                   interp: str = "cubic", linearize=None,
                   geometries: _SolveGeometries = None):
    """Linearised dTEC operator about m0 and its exact transpose:
    (apply, applyt, g0) with the data space flattened to (Na·Nd,), plus
    the anchor rows (A,) and the probe rows (P,) when given. ``m0`` is
    one field; tangents and cotangents may carry leading member axes.
    ``geometries``: from ``_geometries`` over the same bundle (built here
    when None)."""
    linearize = linearize or tec_mod.dtec_paired_linear
    geo = geometries or _SolveGeometries(None, None)
    op = linearize(m0, grid, rays, num_directions, i0, quadrature, interp,
                   geometry=geo.rays)
    if anchors is not None or probes is not None:
        ops = [op]
        if anchors is not None:
            ops.append(tec_mod.tec_linear_op(
                m0, grid, anchors.rays, quadrature, interp,
                geometry=geo.anchors,
                ref=linearize is tec_mod.dtec_paired_linear_ref))
        if probes is not None:
            ops.append(tec_mod.LogNeLinear(m0, grid, probes.points, interp))
        op = _StackedRows(ops)
    return op.apply, op.apply_t, op.g0


def _join_anchor_rows(d, cd_diag, anchors, probes=None):
    """Append the absolute-TEC anchor rows and the point-density probe
    rows to a flat data vector and its noise-variance diagonal, in
    ``anchored_forward``'s [dTEC, anchors, probes] order."""
    for extra in (anchors, probes):
        if extra is None:
            continue
        values = torch.as_tensor(extra.values, dtype=d.dtype,
                                 device=d.device)
        d = torch.cat([d, _flat(values)])
        cd_diag = torch.cat([cd_diag, _noise_vector(
            extra.noise_std, values.shape, d) ** 2])
    return d, cd_diag


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
    Jacobian (rhs and matvec) from a coarser bundle and/or another field
    model (e.g. ``interp="cubic", interp_inner="zp"``) while residuals
    stay on ``rays``/``interp`` (mixed-fidelity inexact Gauss-Newton). ``warm_start``: carry the whitened CG solution
    u across Gauss-Newton steps (rescaled, ``linalg.cg`` ``scale_x0``);
    ``u0`` carries it between calls over the same data. info is
    (residual per step, CG iterations per step, CG residual per step).
    """
    m_prior = as_tensor(m_prior, device=grid.device)
    d_obs = torch.as_tensor(d_obs, dtype=torch.float32,
                            device=m_prior.device)
    d = d_obs.reshape(-1)
    cd_diag = _noise_vector(noise_std, d_obs.shape, d) ** 2
    d, cd_diag = _join_anchor_rows(d, cd_diag, anchors, probes)
    inv_cd = 1.0 / cd_diag
    inner_model = interp_inner or interp
    shape = grid.shape

    m_k = m_prior if m0 is None else as_tensor(m0, device=grid.device)
    u = (torch.zeros(m_k.numel(), dtype=torch.float32, device=m_k.device)
         if u0 is None else as_tensor(u0, device=grid.device).reshape(-1))
    mixed = rays_inner is not None or inner_model != interp
    if gn_iters > 0:
        geos = _geometries(grid, rays, num_directions, i0, anchors,
                           quadrature, interp, linearize)
        geos_c = (_geometries(grid, rays_inner if rays_inner is not None
                              else rays, num_directions, i0, anchors,
                              quadrature, inner_model, linearize)
                  if mixed else None)
    res_hist, it_hist, cg_hist = [], [], []
    for _ in range(gn_iters):
        apply_j, apply_jt, g0 = _dtec_operator(
            grid, rays, num_directions, i0, m_k, anchors,
            quadrature=quadrature, probes=probes, interp=interp,
            linearize=linearize, geometries=geos)
        if mixed:
            apply_jc, apply_jtc, _ = _dtec_operator(
                grid, rays_inner if rays_inner is not None else rays,
                num_directions, i0, m_k, anchors, quadrature=quadrature,
                probes=probes, interp=inner_model, linearize=linearize,
                geometries=geos_c)
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


def map_gauss_newton_robust(grid: Grid3D, rays: RayBundle, d_obs,
                            noise_std, m_prior, cov: GPCovariance,
                            num_directions: int, i0: int = 0,
                            gn_iters: int = 1, cg_iters: int = 30,
                            cg_tol: float = 1e-4, huber_k: float = 3.0,
                            irls_iters: int = 3,
                            quadrature: str = "hermite",
                            rays_inner: RayBundle = None,
                            interp: str = "cubic",
                            warm_start: bool = False,
                            interp_inner: str = None, linearize=None
                            ) -> InversionResult:
    """Outlier-robust MAP: Huber loss on the whitened data residual by
    IRLS. Each round re-weights the observations by w = min(1, k/|r/σ|)
    at the current iterate and runs ``map_gauss_newton`` with the noise
    inflated to σ/√w, so unflagged corrupted samples (RFI, cycle slips)
    are down-weighted instead of dragging the reconstruction.

    ``rays_inner``/``interp_inner``: mixed-fidelity linear solves (see
    ``map_gauss_newton``); the re-weighting residual stays full-fidelity.
    ``warm_start``: carry the whitened departure across the rounds too.
    info is (the final residual of each round (irls_iters,), the number
    of down-weighted samples of each round (irls_iters,)).
    """
    m_prior = as_tensor(m_prior, device=grid.device)
    d = torch.as_tensor(d_obs, dtype=torch.float32, device=m_prior.device)
    sigma = torch.broadcast_to(torch.as_tensor(
        noise_std, dtype=torch.float32, device=d.device), d.shape)
    m_k = m_prior
    u = torch.zeros(m_prior.numel(), dtype=torch.float32, device=d.device)
    res_hist, n_down = [], []
    for _ in range(irls_iters):
        g = tec_mod.dtec_paired_q(m_k, grid, rays, num_directions, i0,
                                  quadrature, interp)
        r_w = torch.abs(g - d) / sigma
        w = torch.clamp(huber_k / torch.clamp_min(r_w, 1e-12), max=1.0)
        noise_eff = sigma / torch.sqrt(torch.clamp_min(w, 1e-12))
        res = map_gauss_newton(grid, rays, d, noise_eff, m_prior, cov,
                               num_directions=num_directions, i0=i0,
                               gn_iters=gn_iters, cg_iters=cg_iters,
                               cg_tol=cg_tol, m0=m_k,
                               quadrature=quadrature, rays_inner=rays_inner,
                               interp=interp, warm_start=warm_start, u0=u,
                               interp_inner=interp_inner,
                               linearize=linearize)
        if warm_start:
            u = res.u_final
        m_k = res.m
        res_hist.append(res.residual_norm)
        n_down.append(torch.sum(w < 1.0))
    res_hist = torch.stack(res_hist)
    return InversionResult(m=m_k, residual_norm=res_hist[-1],
                           info=(res_hist, torch.stack(n_down)))


def posterior_samples(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                      m_prior, cov: GPCovariance, num_directions: int,
                      data_noise, prior_noise, i0: int = 0,
                      cg_iters: int = 40, cg_tol: float = 1e-4,
                      anchors=None, quadrature: str = "hermite",
                      interp: str = "cubic", linearize=None):
    """Randomise-then-optimise posterior sampling (uncertainty beyond MAP).

    Draws from the linearised Bayesian posterior by solving the MAP system
    with perturbed data d + C_d^{1/2}ε and perturbed prior mean
    m_prior + C^{1/2}η, each solve map_gauss_newton's inner system. The
    draws are fed in as standard normals: ``data_noise`` ε (S, n_data),
    n_data = Na·Nd plus the anchor rows, and ``prior_noise`` η (S,
    *grid.shape) (the reference splits its key into the two). All S
    solves are one batched CG over a member axis (K2b and K3b on the
    card). Returns (samples (S, *grid.shape), mean, std).

    ``anchors``: absolute-TEC rows joined to the data space, perturbed by
    their noise like every other row.
    """
    m_prior = as_tensor(m_prior, device=grid.device)
    dev = m_prior.device
    d_obs = torch.as_tensor(d_obs, dtype=torch.float32, device=dev)
    d = d_obs.reshape(-1)
    cd_diag = _noise_vector(noise_std, d_obs.shape, d) ** 2
    d, cd_diag = _join_anchor_rows(d, cd_diag, anchors)
    inv_cd = 1.0 / cd_diag
    apply_j, apply_jt, g0 = _dtec_operator(
        grid, rays, num_directions, i0, m_prior, anchors,
        quadrature=quadrature, interp=interp, linearize=linearize)
    r0 = d - g0
    eps = as_tensor(data_noise, device=dev) * torch.sqrt(cd_diag)[None, :]
    eta = as_tensor(prior_noise, device=dev)
    n = eta.shape[0]
    shape = (n,) + tuple(grid.shape)

    def matvec(u):
        v = cov.apply_sqrt(u.reshape(shape))
        w = apply_j(v) * inv_cd
        return u + cov.apply_sqrt(apply_jt(w)).reshape(n, -1)

    # perturbed systems: each data residual gains its noise draw, each
    # prior mean shifts by its prior draw (whose J-image enters the rhs)
    prior_shift = cov.apply_sqrt(eta)
    rhs_vec = (r0[None] + eps - apply_j(prior_shift)) * inv_cd
    rhs = cov.apply_sqrt(apply_jt(rhs_vec)).reshape(n, -1)
    u, _ = linalg.cg(matvec, rhs, max_iters=cg_iters, tol=cg_tol,
                     batch_dims=1)
    samples = m_prior[None] + prior_shift + cov.apply_sqrt(u.reshape(shape))
    return samples, samples.mean(0), samples.std(0, correction=0)


def map_gauss_newton_batched(grid: Grid3D, rays_seq: RayBundle, d_obs_seq,
                             noise_std, m_prior, cov: GPCovariance,
                             num_directions: int, i0: int = 0,
                             gn_iters: int = 2, cg_iters: int = 30,
                             cg_tol: float = 1e-4,
                             quadrature: str = "hermite",
                             rays_inner_seq: RayBundle = None,
                             interp: str = "cubic",
                             warm_start: bool = False,
                             interp_inner: str = None, linearize=None
                             ) -> InversionResult:
    """Independent snapshots, each inverted from the prior (SURVEY.md §2.1
    P2; the reference runs them as one vmapped batch). Every epoch carries
    its own rays, so each is one ``map_gauss_newton`` over its own
    geometry; the reference's fixed-trip masked CG makes the batch equal
    to the per-snapshot solves, and so are these.

    rays_seq: RayBundle with a leading time axis (points (Nt, R, N, 3),
    ds (Nt, R)); d_obs_seq (Nt, Na, Nd); noise_std broadcastable to
    d_obs_seq; or a ray-sharded sequence (``parallel.sharding.
    ShardedRayBundle`` with the ray axis at 1), each epoch then solved on
    its shards. ``rays_inner_seq``: mixed-fidelity solves (same leading
    axis). Returns the InversionResult with each field stacked along time.
    """
    d_seq = torch.as_tensor(d_obs_seq, dtype=torch.float32,
                            device=grid.device)
    noise_seq = torch.broadcast_to(torch.as_tensor(
        noise_std, dtype=torch.float32, device=d_seq.device), d_seq.shape)
    out = []
    for t in range(d_seq.shape[0]):
        inner = None if rays_inner_seq is None else rays_inner_seq.step(t)
        out.append(map_gauss_newton(
            grid, rays_seq.step(t), d_seq[t], noise_seq[t], m_prior, cov,
            num_directions=num_directions, i0=i0, gn_iters=gn_iters,
            cg_iters=cg_iters, cg_tol=cg_tol, quadrature=quadrature,
            interp=interp, rays_inner=inner, warm_start=warm_start,
            interp_inner=interp_inner, linearize=linearize))
    return InversionResult(
        m=torch.stack([r.m for r in out]),
        residual_norm=torch.stack([r.residual_norm for r in out]),
        info=tuple(torch.stack(parts) for parts in zip(*(r.info
                                                        for r in out))),
        u_final=(torch.stack([r.u_final for r in out]) if warm_start
                 else None))


def steepest_descent_map(grid: Grid3D, rays: RayBundle, d_obs, noise_std,
                         m_prior, cov: GPCovariance, num_directions: int,
                         i0: int = 0, n_iters: int = 20,
                         n_linesearch: int = 8, eps_max: float = 1.0
                         ) -> InversionResult:
    """Reference-style covariance-preconditioned steepest descent with a
    grid line search (SURVEY.md §8: m ← m − ε(C_m Jᵀ C_d⁻¹ r + (m −
    m_prior)), line-searched ε), kept for behavioural parity with the
    reference pipeline; Gauss-Newton is the faster default.

    As in the reference, the objective is ``tec.dtec_paired`` at its
    defaults (Simpson, ``interp="cubic"``) whatever the caller's
    quadrature, ε runs over a grid of ``n_linesearch`` steps (0 and a
    log-spaced 1e-3..1 × ``eps_max``), and the direction is normalised by
    its largest entry. The data gradient Jᵀ((g − d)·σ⁻²) is the
    linearised operator's transpose about the iterate; the
    ``n_linesearch`` objectives are the forward alone over a member axis
    (``tec.dtec_paired_over``: K2b on the card), on the samples' one
    geometry. info is (the objective accepted at each iteration
    (n_iters,),).
    """
    m_prior = as_tensor(m_prior, device=grid.device)
    dev = m_prior.device
    d = torch.as_tensor(d_obs, dtype=torch.float32, device=dev)
    inv_var = 1.0 / torch.broadcast_to(torch.as_tensor(
        noise_std, dtype=torch.float32, device=dev), d.shape) ** 2
    d, inv_var = d.reshape(-1), inv_var.reshape(-1)
    geo = tec_mod.dtec_geometry(grid, rays, num_directions, i0, "simpson",
                                "cubic")

    def objective(ms):
        g = tec_mod.dtec_paired_over(ms, geo)
        data = 0.5 * torch.sum((g - d) ** 2 * inv_var, dim=-1)
        dmp = ms - m_prior
        prior = 0.5 * torch.sum(dmp * cov.apply_inv(dmp), dim=(-3, -2, -1))
        return data + prior

    epsilons = torch.cat([
        torch.zeros(1, device=dev),
        torch.logspace(-3, 0, n_linesearch - 1, device=dev)]) * eps_max
    m_k, hist = m_prior, []
    for _ in range(n_iters):
        op = tec_mod.dtec_paired_linear(m_k, grid, rays, num_directions, i0,
                                        "simpson", "cubic", geometry=geo)
        grad_data = op.apply_t((op.g0 - d) * inv_var)
        direction = -(cov.apply(grad_data) + (m_k - m_prior))
        # normalise so ε is a step in log-density units: the raw
        # preconditioned gradient's scale depends on C_d and would
        # overflow exp(m) for any fixed ε grid
        direction = direction / (torch.max(torch.abs(direction)) + 1e-20)
        objs = objective(m_k[None] + epsilons[:, None, None, None]
                         * direction[None])
        best = torch.argmin(objs)
        m_k = m_k + epsilons[best] * direction
        hist.append(objs[best])
    g = tec_mod.dtec_paired_over(m_k, geo)
    res = torch.linalg.norm((g - d) * torch.sqrt(inv_var))
    return InversionResult(m=m_k, residual_norm=res,
                           info=(torch.stack(hist),))
