"""Time-evolving tomography: the frozen-flow Kalman filter (config 5) and
its ensemble variant (port of ``ionotomo_tpu.inversion.kalman``).

Model: state = log-density grid m_t; transition = frozen-flow advection
by the bulk wind (n_e(x, t+Δt) = n_e(x − vΔt, t)) plus process noise;
measurement = the dTEC ray operator.

The full voxel covariance (10⁶×10⁶ for 128³) is never formed. The point
filter runs in the **stationary-covariance approximation**: the prior
covariance C_m (a GP kernel, applied spectrally) is advection-invariant
and process noise re-inflates toward C_m through the fade factor γ. Its
known limitation: C never narrows with accumulated information, so
per-step updates stay prior-weighted. When calibrated time-propagated
uncertainty matters, ``ensemble_kalman_filter`` carries the information
the stationary filter discards, with multiplicative ``inflation`` and
additive ``process_sigma`` noise as the standard calibration controls.

    predict:  m_pred = advect(m_t, vΔt);  C ≡ C_m (γ-blended prior pull)
    update:   data-space representer solve, config 4's CG:
              m_{t+1} = m_pred + C Jᵀ (J C Jᵀ + C_d)⁻¹ (d_t − g(m_pred))

How the port runs it. The reference's ``lax.scan`` over time is a Python
loop that reads nothing back from the card, so the steps queue ahead of
it. Each step linearises ``forward.tec.PairedDtecLinear`` about its
prediction over a ``DtecGeometry`` (point set-up and scatter plans) that
is built once per distinct bundle: a bundle expanded along the time axis
(stride 0) shares one geometry over all steps, and chunked calls (of one
step too) share it when the caller passes one ``geometry_cache`` dict to
each. The ensemble
filter carries its members as a leading tensor axis through every
operation of the update: advection, the prior's FFTs, the prefilter, the
batched CG (``core.linalg.cg(batch_dims=1)``) and the value gather and
scatter (kernels K2b and K3b); only the Hermite endpoint terms launch
their kernels once per member.

Randomness is fed in as arrays of unit normals, indexed by the global
step ``step_offset + t`` where the reference folds that step into its
key, so chunked and single-call runs consume the same draws and agree
bitwise.

``update_operator_eigs`` is the serving layer's spectrum diagnostic of
the update operator, one batched application of J and Jᵀ a block.

Not ported: ``spectrum_blend`` (withdrawn in the reference: measured
neutral; the argument raises) and the reference's
``inversion/kalman.py:member_parallel_enkf`` with ``member_axis``
(ROADMAP.md Queue 1, multi-GPU).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import linalg
from ..core.grids import Grid3D
from ..device import as_tensor
from ..forward import tec as tec_mod
from ..geometry.rays import RayBundle
from ..models.frozen_flow import advect_periodic, advect_periodic_tangents
from .anchors import (anchor_map_step, anchor_sqrt_update, inv_variance,
                      whitened_gain)
from .priors import GPCovariance


def initial_ensemble(grid: Grid3D, cov: GPCovariance, m0: torch.Tensor,
                     init_noise: torch.Tensor) -> torch.Tensor:
    """The ensemble filter's initial ensemble: prior mean + one prior
    draw per member, C^{1/2} of the unit normals ``init_noise`` (B,
    *grid.shape) (the reference draws them from the reserved key slot
    ``fold_in(key, 0x7FFFFFFF)``)."""
    return m0[None] + cov.apply_sqrt(as_tensor(init_noise,
                                               device=grid.device))


class _Geometries:
    """The ``DtecGeometry`` of each step's bundle, built once per distinct
    bundle. A step's bundle is known by the storage of its points and ds,
    so the steps of a bundle expanded along the time axis (stride 0) share
    one geometry, and so do chunked calls that are given the same
    ``cache`` dict and the same bundle (a geometry holds its bundle, so
    the storage it is known by stays alive with it). Without a caller's
    cache only shared bundles are kept: the geometries of bundles that
    differ by step are dropped after their step."""

    def __init__(self, grid, num_directions, i0, quadrature, plans, cache):
        self.args = (grid, num_directions, i0, quadrature)
        self.plans = plans
        self.keep_all = cache is not None
        self.cache = {} if cache is None else cache

    def get(self, rays_seq: RayBundle, t: int, interp: str):
        rays_t = RayBundle(points=rays_seq.points[t], ds=rays_seq.ds[t])
        grid, nd, i0, quadrature = self.args
        key = (rays_t.points.data_ptr(), tuple(rays_t.points.shape),
               rays_t.ds.data_ptr(), nd, i0, quadrature, interp, self.plans)
        geo = self.cache.get(key)
        if geo is None:
            geo = tec_mod.DtecGeometry(grid, rays_t, nd, i0, quadrature,
                                       interp, self.plans)
            if self.keep_all or rays_seq.points.stride(0) == 0:
                self.cache[key] = geo
        return geo


def _wind_innovation_refine(grid, m_t, geometry, d_t, cd_t, clim, wind,
                            dt_s, fade, n_iters, damping, wind_mask,
                            linearize):
    """Damped Gauss-Newton on the innovation over the wind parameters: a
    (3,) rigid wind or a (2, 3) rigid + shear state
    (``models.frozen_flow.advect_periodic``). The phase-ramp advection is
    analytic in the shift: the k-column Jacobian is J_g applied to the k
    advection tangents (``advect_periodic_tangents``), one batched
    application, where the reference takes k forward tangents through
    advect + forward model. Masked parameters have zero columns; the
    Levenberg term keeps the system nonsingular and their update is
    exactly 0."""
    k = wind.numel()
    sqrt_cd = torch.sqrt(cd_t)
    scale = (fade * dt_s) * wind_mask.reshape(-1)
    eye = torch.eye(k, dtype=wind.dtype, device=wind.device)
    geo = geometry
    for _ in range(n_iters):
        shift = (wind * wind_mask) * dt_s
        m_pred = fade * advect_periodic(m_t, grid, shift) + (1 - fade) * clim
        op = linearize(m_pred, grid, geo.rays, geo.nd, geo.i0,
                       geo.quadrature, geo.interp, geometry=geo)
        r = (d_t - op.g0) / sqrt_cd
        tangents = advect_periodic_tangents(m_t, grid, shift)
        j_cols = -op.apply(tangents * scale[:, None, None, None]) / sqrt_cd
        g = torch.sum(j_cols * r[None, :], dim=1)
        h = j_cols @ j_cols.T
        lam = damping * (torch.trace(h) / k + 1e-12)
        # solve_ex: no error check, so no read of the card on the host
        dw = torch.linalg.solve_ex(h + lam * eye, g).result
        wind = (wind - dw.reshape(wind.shape)) * wind_mask \
            + wind * (1 - wind_mask)
    return wind


#: Rows with noise variance above this are flag-inflated (a serving layer
#: marks flagged data with noise_std = 1e6, variance 1e12) and are left
#: out of the innovation-consistency statistics: they carry no information
#: about the true noise floor and their near-zero whitened innovations
#: would bias the estimated scale toward zero.
_FLAG_VAR_CUTOFF = 1e9


def _innov_noise_scale_sq(nu, s_diag, v_diag, n_iter: int = 8):
    """Per-epoch noise-scale-squared estimate ρ̂² from one innovation
    vector, the statistic behind an adaptive observation-noise scale.

    Under the filter's own assumed statistics the innovation is
    ν_i ~ N(0, s_i + ρ²·v_i) with s_i = diag(H P_f Hᵀ) the predicted
    signal variance and v_i the applied noise variance; ρ² = 1 means the
    noise is calibrated. Returns the one-parameter maximum-likelihood ρ̂²
    by its fixed-point iteration

        ρ² ← Σ_i a_i (ν_i² − s_i) / Σ_i a_i v_i,   a_i = v_i/(s_i+ρ²v_i)²

    and not the naive moment match mean[(ν²−s)/v]: most rows have
    s_i ≫ v_i, where that ratio is a near-cancellation whose sampling
    noise swamps the answer; the weights a_i give such rows
    asymptotically zero weight. Flag-inflated rows are masked out; the
    estimate is clipped to [1e-2, 1e4]."""
    mask = v_diag < _FLAG_VAR_CUTOFF
    v = torch.where(mask, v_diag, 1.0)
    a_mask = mask.to(nu.dtype)
    nu2 = nu * nu
    rho2 = torch.ones((), dtype=nu.dtype, device=nu.device)
    for _ in range(n_iter):
        tot = s_diag + rho2 * v
        a = a_mask * v / (tot * tot)
        num = torch.sum(a * (nu2 - s_diag))
        den = torch.sum(a * v)
        rho2 = torch.clamp(num / torch.clamp_min(den, 1e-20), 1e-2, 1e4)
    return rho2


def update_operator_eigs(grid: Grid3D, rays: RayBundle, noise_std, m_lin,
                         cov: GPCovariance, num_directions: int, z,
                         rank: int = 16, i0: int = 0, power_iters: int = 2,
                         oversample: int = 8, quadrature: str = "hermite",
                         interp: str = "cubic"):
    """Top-``rank`` eigenpairs of the filter/MAP update operator
    I + C^{1/2} Jᵀ C_d⁻¹ J C^{1/2}, linearised at ``m_lin``: a spectrum
    diagnostic (``core.linalg.subspace_eigs``). The decay of ``lam`` is
    the effective number of data-dominated directions per update and λ₁
    the system's condition number, the quantities that size ``cg_iters``.
    ``z``: the (n_voxels, rank + oversample) start block of standard
    normals. Not a preconditioner (the reference measured deflating these
    directions in truncated CG as harmful).

    The block's columns go through the operator as one member axis:
    C^{1/2} by batched FFTs, J and Jᵀ by ``PairedDtecLinear`` with a
    leading axis (K2b and K3b on the card). Cost: ``power_iters + 1``
    block applications.
    """
    dev = grid.device
    nd = int(num_directions)
    na = rays.points.shape[0] // nd
    cd = torch.broadcast_to(torch.as_tensor(noise_std, dtype=torch.float32,
                                            device=dev),
                            (na, nd)).reshape(-1) ** 2
    inv_cd = 1.0 / cd
    op = tec_mod.dtec_paired_linear(as_tensor(m_lin, device=dev), grid, rays,
                                    nd, i0, quadrature, interp)

    def matvec(u):
        p = u.shape[1]
        v = cov.apply_sqrt(u.T.reshape((p,) + grid.shape))
        w = op.apply(v) * inv_cd
        back = cov.apply_sqrt(op.apply_t(w)).reshape(p, -1)
        return u + back.T

    return linalg.subspace_eigs(matvec, grid.num_voxels, rank,
                                as_tensor(z, device=dev), iters=power_iters,
                                oversample=oversample)


class KalmanResult(NamedTuple):
    m_seq: torch.Tensor           # (Nt, *grid.shape) filtered states
    residuals: torch.Tensor       # (Nt,) pre-update whitened residual norms
    post_residuals: torch.Tensor  # (Nt,) post-update whitened residual norms
    wind_seq: torch.Tensor = None  # (Nt, 3), or (Nt, 2, 3) for the rigid +
                                   # shear state: per-step wind [km/s] when
                                   # wind_adapt_iters > 0
    innov_q: torch.Tensor = None   # (Nt,) per-epoch noise-scale-squared
                                   # MLEs when innov_stats=True


class _Setup(NamedTuple):
    """What both filters derive from their arguments before the loop."""
    d_seq: torch.Tensor
    cd_seq: torch.Tensor
    m_clim: torch.Tensor
    wind: torch.Tensor
    wind_mask: torch.Tensor
    a_vals_seq: torch.Tensor
    a_inv_cd: torch.Tensor
    a_noise: torch.Tensor
    anchor_geo: object
    inner_model: str
    mixed: bool
    geos: _Geometries
    linearize: object


def _setup(grid, d_obs_seq, noise_std, m0, m_clim, wind_kmps,
           wind_adapt_horizontal, anchors, anchor_values_seq, anchor_cov,
           quadrature, interp, interp_inner, rays_inner_seq, num_directions,
           i0, linearize, geometry_cache, who) -> _Setup:
    dev = grid.device
    d_seq = as_tensor(d_obs_seq, device=dev)
    nt = d_seq.shape[0]
    # noise may be scalar, per-(antenna, direction), or fully per-timestep
    # (Nt, Na, Nd), e.g. time-varying flag inflation
    noise = torch.as_tensor(noise_std, dtype=torch.float32, device=dev)
    cd_seq = torch.broadcast_to(noise, d_seq.shape).reshape(nt, -1) ** 2
    wind = torch.as_tensor(wind_kmps, dtype=torch.float32, device=dev)
    # the mask broadcasts over the wind state's shape: (3,) rigid or (2, 3)
    # rigid + shear (row 1's v_z is always pinned, see advect_periodic)
    # (built on the device: a tensor made from a Python list would be
    # copied from the host, and the copy waits for the card)
    wind_mask = torch.broadcast_to(
        (torch.arange(3, device=dev) < (2 if wind_adapt_horizontal else 3)
         ).to(torch.float32), wind.shape)
    a_vals_seq = a_inv_cd = a_noise = anchor_geo = None
    if anchors is not None:
        if anchor_cov is None:
            raise ValueError(
                f"{who}(anchors=...) needs anchor_cov (the background-error "
                f"covariance, e.g. anchors.background_covariance(grid))")
        a_vals_seq = (torch.broadcast_to(
            anchors.values, (nt,) + tuple(anchors.values.shape[-1:]))
            if anchor_values_seq is None
            else as_tensor(anchor_values_seq, device=dev))
        a_noise = torch.broadcast_to(
            torch.as_tensor(anchors.noise_std, dtype=torch.float32,
                            device=dev), anchors.values.shape[-1:]).reshape(-1)
        a_inv_cd = inv_variance(anchors.noise_std, anchors.values)
        anchor_geo = tec_mod.DtecGeometry(grid, anchors.rays, None, None,
                                          quadrature, interp)
    inner_model = interp_inner or interp
    linearize = linearize or tec_mod.dtec_paired_linear
    geos = _Geometries(grid, num_directions, i0, quadrature,
                       linearize is not tec_mod.dtec_paired_linear_ref,
                       geometry_cache)
    return _Setup(d_seq, cd_seq, m0 if m_clim is None else
                  as_tensor(m_clim, device=dev), wind, wind_mask,
                  a_vals_seq, a_inv_cd, a_noise, anchor_geo, inner_model,
                  rays_inner_seq is not None or inner_model != interp, geos,
                  linearize)


def _linearize_at(s: _Setup, m, geo):
    return s.linearize(m, geo.grid, geo.rays, geo.nd, geo.i0, geo.quadrature,
                       geo.interp, geometry=geo)


def kalman_filter(grid: Grid3D, rays_seq: RayBundle, d_obs_seq, noise_std,
                  m0, cov: GPCovariance, wind_kmps, dt_s,
                  num_directions: int, i0: int = 0, cg_iters: int = 30,
                  cg_tol: float = 1e-4, fade: float = 1.0,
                  advect_first: bool = False, m_clim=None,
                  anchors=None, anchor_values_seq=None,
                  anchor_cov: GPCovariance = None,
                  anchor_cg_iters: int = 8,
                  quadrature: str = "hermite", interp: str = "cubic",
                  m_clim_seq=None, rays_inner_seq: RayBundle = None,
                  wind_adapt_iters: int = 0,
                  wind_adapt_damping: float = 0.1,
                  wind_adapt_horizontal: bool = True,
                  innov_stats: bool = False, stats_noise=None,
                  interp_inner: str = None, linearize=None,
                  geometry_cache: dict = None) -> KalmanResult:
    """Run the filter over Nt timesteps.

    rays_seq: RayBundle with a leading time axis, points (Nt, R, N, 3),
    ds (Nt, R); one bundle for all steps is passed expanded
    (``points.expand(Nt, ...)``) and then set up once. d_obs_seq: (Nt,
    Na, Nd). fade ∈ (0, 1]: per-step pull of the prediction toward the
    climatological prior mean (process-noise proxy; 1.0 = pure frozen
    flow). ``advect_first``: advect before the first update too, for a
    call that continues a filter from a checkpointed state (m0 is then
    the filtered state at the previous timestep), so a long sequence can
    be chunked into several calls without changing the result.
    ``m_clim``: the climatological field the fade pull targets (default
    m0; a chunked continuation must pass the original prior, since its m0
    is the carried state).

    ``anchors`` (``inversion.anchors.TecAnchors``): per-epoch absolute-TEC
    constraints. Each step's *prediction* is first MAP-updated against
    the epoch's anchor values through ``anchor_cov`` (the long-horizontal
    background-error covariance, required with anchors), then the dTEC
    update runs as usual. ``anchor_values_seq`` (Nt, A) overrides
    ``anchors.values`` per epoch.

    ``m_clim_seq`` (Nt, *grid.shape): per-epoch climatological fields, for
    a deployment whose background follows the diurnal cycle.

    ``rays_inner_seq``: a coarser-sampled bundle over the same geometry
    (e.g. hermite@33 beside the fine @65) for the linear solve:
    mixed-fidelity (inexact Gauss-Newton) updates. The data misfit and all
    residuals are evaluated with the full-fidelity forward on ``rays_seq``;
    the update's Jacobian, rhs and matvec both (which is what keeps the
    step a contraction), is the coarse operator's. ``interp_inner``: the
    same with another field model for the Jacobian (e.g. interp="cubic",
    interp_inner="zp"). They compose.

    ``innov_stats`` (with ``stats_noise`` (Nt, probes, *grid.shape) unit
    normals): also return the per-step noise-scale-squared MLE
    ``innov_q`` (``_innov_noise_scale_sq``); diag(H C_m Hᵀ) is estimated
    from the C^{1/2}-filtered probes pushed through the full-fidelity J.

    ``wind_adapt_iters`` (> 0 enables): online wind tracking. Before each
    predict (except the first step of a fresh sequence, which has no
    transition) the wind is refined by this many damped Gauss-Newton
    iterations on the innovation (``_wind_innovation_refine``). The
    carried wind persists across chunked calls via ``wind_seq[-1]`` → the
    next call's ``wind_kmps``. ``wind_adapt_damping`` is the relative
    Levenberg damping; ``wind_adapt_horizontal`` pins v_z = 0.
    ``wind_kmps`` of shape (2, 3) is the rigid + vertical-shear state
    (``advect_periodic``'s shear form); all 4 unmasked parameters are
    then refined.

    ``linearize``: the factory of the linearised operator (default
    ``tec.dtec_paired_linear``; ``tec.dtec_paired_linear_ref`` runs the
    filter on the plain versions of the kernels). ``geometry_cache``: a
    dict the caller keeps across chunked calls so the bundles' set-up and
    scatter plans are built once per run.
    """
    m_t = as_tensor(m0, device=grid.device)
    s = _setup(grid, d_obs_seq, noise_std, m_t, m_clim, wind_kmps,
               wind_adapt_horizontal, anchors, anchor_values_seq, anchor_cov,
               quadrature, interp, interp_inner, rays_inner_seq,
               num_directions, i0, linearize, geometry_cache,
               "kalman_filter")
    nt = s.d_seq.shape[0]
    if innov_stats:
        if stats_noise is None:
            raise ValueError("innov_stats=True needs stats_noise")
        stats_noise = as_tensor(stats_noise, device=grid.device)
    if m_clim_seq is not None:
        m_clim_seq = as_tensor(m_clim_seq, device=grid.device)
    adapt = wind_adapt_iters > 0
    wind = s.wind
    shift = wind * dt_s
    m_seq, pre_seq, post_seq, wind_hist, q_seq = [], [], [], [], []
    for t in range(nt):
        d_t, cd_t = s.d_seq[t].reshape(-1), s.cd_seq[t]
        inv_cd, sqrt_cd = 1.0 / cd_t, torch.sqrt(cd_t)
        geo = s.geos.get(rays_seq, t, interp)
        is_first = t == 0 and not advect_first
        clim = s.m_clim if m_clim_seq is None else m_clim_seq[t]
        if adapt and not is_first:
            # no transition into a fresh sequence's first step, so no wind
            # information in its innovation: it keeps the initial estimate
            wind = _wind_innovation_refine(
                grid, m_t, geo, d_t, cd_t, clim, wind, dt_s, fade,
                wind_adapt_iters, wind_adapt_damping, s.wind_mask,
                s.linearize)
        # predict: advect except at t=0 (the state is already at t=0)
        if is_first:
            m_pred = m_t
        else:
            m_adv = advect_periodic(m_t, grid, wind * dt_s if adapt
                                    else shift)
            m_pred = fade * m_adv + (1 - fade) * clim
        if anchors is not None:
            # pure regularised update about the prediction, fitted with
            # the run's operator discretisation
            m_pred = anchor_map_step(
                grid, m_pred, anchor_cov, anchors.rays, s.a_vals_seq[t],
                s.a_inv_cd, anchor_cg_iters, cg_tol, quadrature=quadrature,
                interp=interp, geometry=s.anchor_geo)
        # update
        op = _linearize_at(s, m_pred, geo)
        r = d_t - op.g0
        if innov_stats:
            hph = torch.mean(op.apply(cov.apply_sqrt(stats_noise[t])) ** 2,
                             dim=0)
            q_seq.append(_innov_noise_scale_sq(r, hph, cd_t))
        op_c = op
        if s.mixed:
            op_c = _linearize_at(s, m_pred, s.geos.get(
                rays_seq if rays_inner_seq is None else rays_inner_seq, t,
                s.inner_model))
        m_t = m_pred + whitened_gain(cov, op_c, r, inv_cd, cg_iters, cg_tol)
        m_seq.append(m_t)
        pre_seq.append(torch.linalg.norm(r / sqrt_cd))
        post_seq.append(torch.linalg.norm(
            (d_t - _linearize_at(s, m_t, geo).g0) / sqrt_cd))
        wind_hist.append(wind)
    return KalmanResult(
        m_seq=torch.stack(m_seq), residuals=torch.stack(pre_seq),
        post_residuals=torch.stack(post_seq),
        wind_seq=torch.stack(wind_hist) if adapt else None,
        innov_q=torch.stack(q_seq) if innov_stats else None)


class EnsembleKalmanResult(NamedTuple):
    mean_seq: torch.Tensor     # (Nt, *grid.shape) ensemble means
    std_seq: torch.Tensor      # (Nt, *grid.shape) ensemble spreads
    residuals: torch.Tensor    # (Nt,) pre-update whitened residuals (mean)
    ensemble: torch.Tensor     # (n_members, *grid.shape) final ensemble:
                               # the carry for chunked continuation (ens0)
    wind_seq: torch.Tensor = None  # (Nt, 3) or (Nt, 2, 3) when
                                   # wind_adapt_iters > 0
    innov_q: torch.Tensor = None   # (Nt,) per-epoch noise-scale-squared
                                   # MLEs when innov_stats=True: hph from
                                   # the forecast ensemble itself


def ensemble_kalman_filter(grid: Grid3D, rays_seq: RayBundle, d_obs_seq,
                           noise_std, m0, cov: GPCovariance, wind_kmps,
                           dt_s, num_directions: int, obs_noise,
                           n_members: int = 8, i0: int = 0,
                           cg_iters: int = 20, cg_tol: float = 1e-4,
                           fade: float = 1.0, process_sigma: float = 0.0,
                           process_noise=None,
                           advect_first: bool = False, m_clim=None,
                           inflation: float = 1.0, ens0=None,
                           init_noise=None, step_offset: int = 0,
                           spectrum_blend: float = 0.0,
                           anchors=None, anchor_values_seq=None,
                           anchor_cov: GPCovariance = None,
                           anchor_cg_iters: int = 8,
                           anchor_update: str = "sqrt", anchor_noise=None,
                           quadrature: str = "hermite",
                           interp: str = "cubic", m_clim_seq=None,
                           rays_inner_seq: RayBundle = None,
                           wind_adapt_iters: int = 0,
                           wind_adapt_damping: float = 0.1,
                           wind_adapt_horizontal: bool = True,
                           innov_stats: bool = False,
                           interp_inner: str = None, linearize=None,
                           geometry_cache: dict = None
                           ) -> EnsembleKalmanResult:
    """Ensemble variant: time-propagated posterior uncertainty.

    An ensemble of n_members states is advected by the frozen flow (plus
    optional process noise ~ process_sigma·C^{1/2}η per step) and each
    member is updated by a randomise-then-optimise solve against data
    perturbed with its own C_d^{1/2} draw. The ensemble spread is a
    consistent (linearised-Gaussian) estimate of the filtered posterior
    std, including information accumulated across timesteps. The members
    are a leading tensor axis of one batched update (module docstring).

    Calibration controls: ``inflation`` scales the predicted ensemble
    spread about its mean each step (not at the very first step of a
    fresh sequence: the prior draws have had no update-induced collapse
    to counter); ``process_sigma`` adds C^{1/2}-correlated process noise
    per step.

    The draws, unit normals indexed by the **global** step
    ``step_offset + t`` (pass the same arrays to every chunk):
    ``obs_noise`` (Nt_total, B, Na·Nd), scaled here by sqrt(C_d);
    ``process_noise`` (Nt_total, B, *grid.shape), needed when
    ``process_sigma`` > 0; ``anchor_noise`` (Nt_total, B, A) for
    ``anchor_update="stochastic"``; ``init_noise`` (B, *grid.shape) for
    the initial ensemble when ``ens0`` is not given.

    Chunked continuation: pass the previous chunk's ``result.ensemble``
    as ``ens0`` with ``advect_first=True``, ``m_clim`` = the original
    prior, and ``step_offset`` = the global index of this chunk's first
    timestep. Chunked and single-call runs are bit-identical.

    ``anchors``/``anchor_values_seq``/``anchor_cov``: per-epoch
    absolute-TEC anchoring of each member's *prediction* (see
    ``kalman_filter``). ``anchor_update="sqrt"`` (default) is the
    deterministic square-root form (mean updated with unperturbed values,
    anomalies contracted by (I−KH)), which removes the
    perturbed-observation sampling noise that dominates at 8 members;
    ``"stochastic"`` keeps the per-member perturbed-value form.

    ``rays_inner_seq``, ``interp_inner``: mixed-fidelity member updates
    (see ``kalman_filter``). ``wind_adapt_iters``: online wind tracking,
    refined on the noiseless ensemble *mean* each step; the members share
    the refined wind. ``innov_stats``: also return per-step
    noise-scale-squared MLEs; diag(H P_f Hᵀ) is the spread of the member
    forwards the updates already compute. ``linearize``,
    ``geometry_cache``: as in ``kalman_filter``.
    """
    if spectrum_blend:
        raise NotImplementedError(
            "spectrum_blend is withdrawn in the reference (measured neutral) "
            "and not ported (ROADMAP.md Queue 1, deliberately not ported: "
            "the reference's ensemble_kalman_filter(spectrum_blend=...))")
    if anchor_update not in ("sqrt", "stochastic"):
        raise ValueError(f"unknown anchor_update: {anchor_update!r}")
    dev = grid.device
    m0 = as_tensor(m0, device=dev)
    s = _setup(grid, d_obs_seq, noise_std, m0, m_clim, wind_kmps,
               wind_adapt_horizontal, anchors, anchor_values_seq, anchor_cov,
               quadrature, interp, interp_inner, rays_inner_seq,
               num_directions, i0, linearize, geometry_cache,
               "ensemble_kalman_filter")
    nt = s.d_seq.shape[0]
    if ens0 is None:
        if init_noise is None:
            raise ValueError("ensemble_kalman_filter needs ens0 or "
                             "init_noise")
        ens0 = initial_ensemble(grid, cov, m0, init_noise)
    ens = as_tensor(ens0, device=dev)
    if ens.shape[0] != n_members:
        raise ValueError(f"the ensemble has {ens.shape[0]} members, "
                         f"n_members={n_members}")
    obs_noise = as_tensor(obs_noise, device=dev)
    if process_sigma and process_noise is None:
        raise ValueError("process_sigma > 0 needs process_noise")
    if anchors is not None and anchor_update == "stochastic" \
            and anchor_noise is None:
        raise ValueError('anchor_update="stochastic" needs anchor_noise')
    if m_clim_seq is not None:
        m_clim_seq = as_tensor(m_clim_seq, device=dev)
    adapt = wind_adapt_iters > 0
    wind = s.wind
    shift = wind * dt_s
    mean_seq, std_seq, pre_seq, wind_hist, q_seq = [], [], [], [], []
    for t in range(nt):
        tg = step_offset + t
        d_t, cd_t = s.d_seq[t].reshape(-1), s.cd_seq[t]
        inv_cd, sqrt_cd = 1.0 / cd_t, torch.sqrt(cd_t)
        geo = s.geos.get(rays_seq, t, interp)
        is_first = t == 0 and not advect_first
        clim = s.m_clim if m_clim_seq is None else m_clim_seq[t]
        if adapt and not is_first:
            # refined on the (noiseless) ensemble mean; drift is a bulk
            # property, not per-member
            wind = _wind_innovation_refine(
                grid, ens.mean(0), geo, d_t, cd_t, clim, wind, dt_s, fade,
                wind_adapt_iters, wind_adapt_damping, s.wind_mask,
                s.linearize)
        if is_first:
            ens_pred = ens
        else:
            m_adv = advect_periodic(ens, grid, wind * dt_s if adapt
                                    else shift)
            ens_pred = fade * m_adv + (1 - fade) * clim
            if process_sigma:
                ens_pred = ens_pred + process_sigma * cov.apply_sqrt(
                    as_tensor(process_noise[tg], device=dev))
        # multiplicative covariance inflation about the ensemble mean, a
        # forecast-ensemble control
        infl_t = 1.0 if is_first else inflation
        ens_mean = ens_pred.mean(0)
        ens_pred = ens_mean[None] + infl_t * (ens_pred - ens_mean[None])
        if anchors is not None:
            a_t = s.a_vals_seq[t]
            kw = dict(quadrature=quadrature, interp=interp,
                      geometry=s.anchor_geo)
            if anchor_update == "sqrt":
                ens_pred = anchor_sqrt_update(
                    grid, ens_pred, anchor_cov, anchors.rays, a_t,
                    s.a_inv_cd, anchor_cg_iters, cg_tol, **kw)
            else:
                # each member's prediction against its own perturbed
                # anchor values: one batched MAP step
                eps_a = as_tensor(anchor_noise[tg], device=dev) \
                    * s.a_noise[None]
                ens_pred = anchor_map_step(
                    grid, ens_pred, anchor_cov, anchors.rays,
                    a_t[None] + eps_a, s.a_inv_cd, anchor_cg_iters, cg_tol,
                    **kw)
        # the members' randomise-then-optimise updates, as one batch
        eps = obs_noise[tg] * sqrt_cd[None, :]
        op = _linearize_at(s, ens_pred, geo)
        g0s = op.g0                                        # (B, Na·Nd)
        op_c = op
        if s.mixed:
            op_c = _linearize_at(s, ens_pred, s.geos.get(
                rays_seq if rays_inner_seq is None else rays_inner_seq, t,
                s.inner_model))
        r = d_t[None] + eps - g0s
        ens = ens_pred + whitened_gain(cov, op_c, r, inv_cd, cg_iters,
                                       cg_tol)
        pres = torch.linalg.norm((d_t[None] - g0s) / sqrt_cd, dim=-1)
        mean_seq.append(ens.mean(0))
        std_seq.append(ens.std(0, correction=0))
        pre_seq.append(pres.mean())
        wind_hist.append(wind)
        if innov_stats:
            # the ensemble's own innovation consistency: ν about the
            # forecast-mean forward, hph from the member forwards' spread
            mu_g = g0s.mean(0)
            hph = g0s.std(0, correction=0) ** 2
            q_seq.append(_innov_noise_scale_sq(d_t - mu_g, hph, cd_t))
    return EnsembleKalmanResult(
        mean_seq=torch.stack(mean_seq), std_seq=torch.stack(std_seq),
        residuals=torch.stack(pre_seq), ensemble=ens,
        wind_seq=torch.stack(wind_hist) if adapt else None,
        innov_q=torch.stack(q_seq) if innov_stats else None)
