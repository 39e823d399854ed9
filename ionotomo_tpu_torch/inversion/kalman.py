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

Multiple devices. Both filters take a ray-sharded bundle sequence
(``parallel.sharding.ShardedRayBundle`` with the ray axis at 1): every
step's geometry is then the sharded one (``tec.dtec_geometry``) and the
operator ``parallel.sharding.ShardedPairedDtecLinear``.
``member_parallel_enkf`` splits the ensemble into S groups, one a device
of a member mesh, each carried end to end by its device; the ensemble's
mean and spread (and the residual mean) are pmeans of the groups'
moments in group order, and each group takes its rows of the globally
drawn noise, so the sharded filter consumes the same numbers.

``spectrum_blend`` (the ensemble filter; experimental, off by default,
measured neutral in the reference) refits each step's update covariance
from the prediction ensemble: the shell-averaged spectrum of its
anomalies (``priors.fit_shell_spectrum``) blended with the prior's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import linalg
from ..core.grids import Grid3D
from ..device import as_tensor
from ..forward import tec as tec_mod
from ..geometry.rays import RayBundle
from ..models.frozen_flow import advect_periodic, advect_periodic_tangents
from ..parallel.sharding import (MEMBER_AXIS, Sharded, on_device, pmean,
                                 split)
from .anchors import (anchor_map_step, anchor_sqrt_update, inv_variance,
                      whitened_gain)
from .priors import GPCovariance, fit_shell_spectrum

#: shells of ``spectrum_blend``'s fit of the prediction anomalies
#: (``priors.fit_shell_spectrum``'s ``n_bins``; the reference's default)
SPECTRUM_BINS = 48


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

    def get(self, rays_seq, t: int, interp: str, device=None):
        """Step t's geometry (of a ``RayBundle`` or a ray-sharded
        ``ShardedRayBundle`` sequence), on ``device`` where a member group
        of the member-parallel filter lives on another than the rays'."""
        grid, nd, i0, quadrature = self.args
        rays_t = rays_seq.step(t)
        if isinstance(rays_seq, RayBundle):
            bundles, first = (rays_t,), rays_seq
        else:
            bundles, first = rays_t.shards, rays_seq.shards[0]
        key = (tuple((b.points.data_ptr(), tuple(b.points.shape),
                      b.ds.data_ptr()) for b in bundles),
               nd, i0, quadrature, interp, self.plans)
        moved = device is not None and device != grid.device
        if moved:
            key = key + (str(device),)
        geo = self.cache.get(key)
        if geo is None:
            if moved:
                grid = grid.to(device)
                rays_t = RayBundle(points=rays_t.points.to(device),
                                   ds=rays_t.ds.to(device))
            geo = tec_mod.dtec_geometry(grid, rays_t, nd, i0, quadrature,
                                        interp, self.plans)
            if self.keep_all or first.points.stride(0) == 0:
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
    na = rays.num_rays // nd
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
        anchor_geo = tec_mod.dtec_geometry(grid, anchors.rays, None, None,
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
                           geometry_cache: dict = None, member_axis=None
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

    Adaptive spectral gain (``spectrum_blend`` ∈ [0, 1], experimental,
    default 0 = off; measured neutral in every regime the reference tried:
    dTEC's information is anisotropic and non-stationary in k-space, which
    a shell-isotropic fit projects away): each step's update covariance is
    ``(1 − blend)·cov.spectrum + blend·fit_shell_spectrum(anomalies,
    n_bins=SPECTRUM_BINS)``, the anomalies those of the inflated
    prediction ensemble about its mean, fitted after inflation and before
    the anchor and data updates. It depends only on the carried ensemble,
    so chunked runs stay bit-identical.

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

    ``member_axis``: internal, set by ``member_parallel_enkf`` to its
    member mesh: the members are carried in groups, one a device (the
    result's ``ensemble`` is then a ``parallel.sharding.Sharded``).
    """
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
    if ens0.shape[0] != n_members:
        raise ValueError(f"the ensemble has {ens0.shape[0]} members, "
                         f"n_members={n_members}")
    groups = _Groups(member_axis, n_members, dev)
    ens = groups.place(ens0)
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
    rep = _Replicas(grid, cov, anchor_cov, anchors, s.anchor_geo, quadrature,
                    interp)
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
                grid, groups.mean(ens), geo, d_t, cd_t, clim, wind, dt_s,
                fade, wind_adapt_iters, wind_adapt_damping, s.wind_mask,
                s.linearize)
        preds = []
        for (lo, hi), e in zip(groups.rows, ens):
            d = e.device
            if is_first:
                preds.append(e)
                continue
            m_adv = advect_periodic(e, rep.grid(d), on_device(
                wind * dt_s if adapt else shift, d))
            p = fade * m_adv + (1 - fade) * on_device(clim, d)
            if process_sigma:
                p = p + process_sigma * rep.cov(d).apply_sqrt(
                    as_tensor(process_noise[tg][lo:hi], device=d))
            preds.append(p)
        # multiplicative covariance inflation about the ensemble mean, a
        # forecast-ensemble control
        infl_t = 1.0 if is_first else inflation
        ens_mean = groups.mean(preds)
        preds = [on_device(ens_mean, p.device)[None]
                 + infl_t * (p - on_device(ens_mean, p.device)[None])
                 for p in preds]
        cov_t = None
        if spectrum_blend > 0.0:
            # adaptive spectral gain: this step's update covariance is the
            # stationary isotropic fit of the inflated prediction
            # anomalies, blended with the static prior spectrum (one
            # group: member_parallel_enkf refuses the blend)
            s_fit = fit_shell_spectrum(preds[0] - ens_mean[None], grid,
                                       n_bins=SPECTRUM_BINS)
            cov_t = dataclasses.replace(
                cov, spectrum=(1.0 - spectrum_blend) * cov.spectrum
                + spectrum_blend * s_fit)
        if anchors is not None:
            a_t = s.a_vals_seq[t]
            m_bar = groups.mean(preds) if groups.devices else None
            for k, ((lo, hi), p) in enumerate(zip(groups.rows, preds)):
                d = p.device
                kw = dict(quadrature=quadrature, interp=interp,
                          geometry=rep.anchor_geo(d))
                if anchor_update == "sqrt":
                    preds[k] = anchor_sqrt_update(
                        rep.grid(d), p, rep.anchor_cov(d),
                        rep.anchor_rays(d), on_device(a_t, d),
                        on_device(s.a_inv_cd, d), anchor_cg_iters, cg_tol,
                        mean=None if m_bar is None else on_device(m_bar, d),
                        **kw)
                else:
                    # each member's prediction against its own perturbed
                    # anchor values: one batched MAP step
                    eps_a = as_tensor(anchor_noise[tg][lo:hi], device=d) \
                        * on_device(s.a_noise, d)[None]
                    preds[k] = anchor_map_step(
                        rep.grid(d), p, rep.anchor_cov(d),
                        rep.anchor_rays(d), on_device(a_t, d)[None] + eps_a,
                        on_device(s.a_inv_cd, d), anchor_cg_iters, cg_tol,
                        **kw)
        # the members' randomise-then-optimise updates, a batch a group,
        # over the step's geometries on the group's device (built once a
        # step and device)
        geos_t = {(id(rays_seq), interp, dev): geo}

        def geo_on(which, model, d):
            key = (id(which), model, d)
            if key not in geos_t:
                geos_t[key] = s.geos.get(which, t, model, d)
            return geos_t[key]

        new, pres, g0s = [], [], []
        for (lo, hi), p in zip(groups.rows, preds):
            d = p.device
            d_d, sqrt_d = on_device(d_t, d), on_device(sqrt_cd, d)
            eps = on_device(obs_noise[tg][lo:hi], d) * sqrt_d[None, :]
            op = _linearize_at(s, p, geo_on(rays_seq, interp, d))
            op_c = op
            if s.mixed:
                op_c = _linearize_at(s, p, geo_on(
                    rays_seq if rays_inner_seq is None else rays_inner_seq,
                    s.inner_model, d))
            r = d_d[None] + eps - op.g0
            new.append(p + whitened_gain(rep.cov(d) if cov_t is None
                                         else cov_t, op_c, r,
                                         on_device(inv_cd, d), cg_iters,
                                         cg_tol))
            pres.append(torch.linalg.norm((d_d[None] - op.g0) / sqrt_d,
                                          dim=-1))
            g0s.append(op.g0)                              # (B, Na·Nd)
        ens = new
        mu = groups.mean(ens)
        mean_seq.append(mu)
        std_seq.append(groups.std(ens, mu))
        pre_seq.append(groups.scalar_mean(pres))
        wind_hist.append(wind)
        if innov_stats:
            # the ensemble's own innovation consistency: ν about the
            # forecast-mean forward, hph from the member forwards' spread
            mu_g = groups.mean(g0s)
            hph = groups.std(g0s, mu_g) ** 2
            q_seq.append(_innov_noise_scale_sq(d_t - mu_g, hph, cd_t))
    return EnsembleKalmanResult(
        mean_seq=torch.stack(mean_seq), std_seq=torch.stack(std_seq),
        residuals=torch.stack(pre_seq), ensemble=groups.result(ens),
        wind_seq=torch.stack(wind_hist) if adapt else None,
        innov_q=torch.stack(q_seq) if innov_stats else None)


class _Groups:
    """The ensemble as the filter carries it: one batch (B, ...) on the
    grid's device, or, under ``member_axis`` (a member mesh), S groups of
    B/S members, group k on the mesh's device k. ``mean``/``std`` reduce
    over all members: the batch's own ``mean(0)``/``std(0)``, or over
    groups the pmeans of the groups' moments in group order on the grid's
    device (the reference's pmeans under its member axis)."""

    def __init__(self, member_axis, n_members: int, device):
        self.devices = None if member_axis is None else member_axis.devices
        self.device = device
        n = 1 if self.devices is None else len(self.devices)
        b = n_members // n
        self.rows = [(k * b, (k + 1) * b) for k in range(n)]

    def place(self, ens0):
        if self.devices is None:
            return [as_tensor(ens0, device=self.device)]
        if not isinstance(ens0, Sharded):
            ens0 = split(as_tensor(ens0, device=self.device), self.devices)
        return [on_device(e, d) for e, d in zip(ens0.shards, self.devices)]

    def result(self, ens):
        return ens[0] if self.devices is None else Sharded(tuple(ens))

    def mean(self, parts):
        if self.devices is None:
            return parts[0].mean(0)
        return pmean([p.mean(0) for p in parts], self.device)

    def std(self, parts, mu):
        if self.devices is None:
            return parts[0].std(0, correction=0)
        # the biased std about the whole ensemble's mean
        return torch.sqrt(pmean(
            [((p - on_device(mu, p.device)[None]) ** 2).mean(0)
             for p in parts], self.device))

    def scalar_mean(self, parts):
        if self.devices is None:
            return parts[0].mean()
        return pmean([p.mean() for p in parts], self.device)


class _Replicas:
    """What a member group needs on its device, copied there once (the
    originals where the device is the grid's): the grid, the prior and the
    anchors' covariance, the anchor rays and their geometry."""

    def __init__(self, grid, cov, anchor_cov, anchors, anchor_geo,
                 quadrature, interp):
        self.home = grid.device
        self.base = dict(grid=grid, cov=cov, anchor_cov=anchor_cov,
                         anchor_rays=None if anchors is None
                         else anchors.rays, anchor_geo=anchor_geo)
        self.args = (quadrature, interp)
        self.cache = {}

    def _get(self, name, device):
        x = self.base[name]
        if x is None or device == self.home:
            return x
        key = (name, str(device))
        if key not in self.cache:
            if name == "grid":
                y = x.to(device)
            elif name in ("cov", "anchor_cov"):
                y = dataclasses.replace(x, spectrum=x.spectrum.to(device))
            elif name == "anchor_rays":
                y = RayBundle(points=x.points.to(device), ds=x.ds.to(device))
            else:
                y = tec_mod.DtecGeometry(self.grid(device),
                                         self.anchor_rays(device), None,
                                         None, *self.args)
            self.cache[key] = y
        return self.cache[key]

    def grid(self, device):
        return self._get("grid", device)

    def cov(self, device):
        return self._get("cov", device)

    def anchor_cov(self, device):
        return self._get("anchor_cov", device)

    def anchor_rays(self, device):
        return self._get("anchor_rays", device)

    def anchor_geo(self, device):
        return self._get("anchor_geo", device)


def member_parallel_enkf(mesh, grid: Grid3D, rays_seq: RayBundle, d_obs_seq,
                         noise_std, m0, cov: GPCovariance, wind_kmps, dt_s,
                         *, ens0, n_members: int = 8, **kwargs):
    """Member-parallel EnKF over the mesh's 'members' axis
    (``parallel.member_mesh``): the ensemble is split into S groups, one a
    device, and each device carries its n_members/S members end to end:
    advection, anchoring and the whole batched Krylov member update,
    including the grid-sized FFT covariance applications that ray
    sharding cannot split (they are per member, not per ray). Cross-device
    traffic a step: the grid-sized pmeans of the ensemble mean and spread
    (one more for the inflation's centring, one for the square-root
    anchor update's mean) and the scalar residual mean, in group order.

    Randomness: the draws (``obs_noise``, ``process_noise``,
    ``anchor_noise``) are made at global shape and each group takes its
    rows, so the sharded filter consumes exactly the unsharded one's
    numbers.

    Requirements, as the reference's: ``ens0`` is required (build it with
    ``initial_ensemble``; a tensor, or a ``parallel.sharding.Sharded``
    from ``member_sharding``); ``n_members`` must divide by the mesh size
    (members are not padded: a phantom member would bias the mean);
    ``spectrum_blend`` is refused, as in the reference (the shell fit is
    not member-axis aware). Every other keyword is
    ``ensemble_kalman_filter``'s. The result's ``ensemble`` is a
    ``Sharded`` of the groups."""
    if MEMBER_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}; build it with "
                         "parallel.member_mesh()")
    n_dev = mesh.shape[MEMBER_AXIS]
    if n_members % n_dev:
        raise ValueError(f"n_members={n_members} must divide the "
                         f"'{MEMBER_AXIS}' mesh size {n_dev} (members are "
                         "not padded)")
    if ens0 is None or ens0.shape[0] != n_members:
        raise ValueError("member_parallel_enkf requires ens0 with "
                         f"n_members={n_members} rows (use "
                         "initial_ensemble)")
    if kwargs.get("spectrum_blend", 0.0):
        raise ValueError("spectrum_blend is unsupported under member "
                         "sharding (shell fit is not member-axis aware)")
    return ensemble_kalman_filter(grid, rays_seq, d_obs_seq, noise_std, m0,
                                  cov, wind_kmps, dt_s, ens0=ens0,
                                  n_members=n_members, member_axis=mesh,
                                  **kwargs)
