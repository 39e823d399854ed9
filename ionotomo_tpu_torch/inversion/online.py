"""Online (streaming) tomography: the serving surface's filters (port of
``ionotomo_tpu.inversion.online``).

A live calibration system receives one observation epoch at a time and
must emit the current ionosphere estimate with bounded latency and
constant memory. This wraps the frozen-flow filters
(``inversion.kalman``) as a push API:

    f = OnlineKalman(grid, cov, m_prior, wind_kmps=(0.3, 0.1, 0), dt_s=30,
                     num_directions=nd)
    for rays_t, d_t, noise_t in stream:
        m_t, diag = f.step(rays_t, d_t, noise_t)

Each ``step`` is one step of the batch filter (Nt = 1), so streamed and
batch runs agree. The step's geometry (point set-up, row plans, point
order) is built for the epoch's bundle and dropped with it: no geometry
cache outlives a step, since the rays change every epoch.

Randomness is fed in, as the port's batch filters take it: the adaptive-R
probes as ``stats_noise`` (probes, *grid.shape) and the ensemble's draws
as ``init_noise``/``obs_noise``/``process_noise``/``anchor_noise`` for
this epoch. A caller that keys them by the persisted epoch index ``t``
(``serving.EpochService``) restarts bit-identically. The state is the
current field (the ensemble for ``OnlineEnsembleKalman``) plus ``t``, the
wind, ``dt_s`` and the adaptive noise scale; ``state_dict``/``load_state``
round-trip it through numpy, with the reference's keys, so a state saved
by either package loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.grids import Grid3D
from ..device import as_tensor, host
from ..geometry.rays import RayBundle, inner_bundle
from .kalman import ensemble_kalman_filter, kalman_filter
from .priors import GPCovariance


def _ema_scale(scale: float, rho2_inst: float, alpha: float,
               bounds) -> float:
    """One EMA step of the adaptive observation-noise scale: the current
    scale S and this epoch's instantaneous noise-scale-squared MLE ρ̂²
    (relative to the applied noise S·σ) combine as
    S² ← S²·((1−α) + α·ρ̂²), clipped to ``bounds``. Float64 host
    arithmetic, so restarted streams reproduce the adapted sequence
    bit-exactly."""
    s2 = (scale * scale) * ((1.0 - alpha) + alpha * rho2_inst)
    lo, hi = bounds
    return float(min(max(np.sqrt(s2), lo), hi))


def _one_step(rays_t: RayBundle, inner_samples: int):
    """The epoch's bundle with a time axis of one, and its coarse inner
    bundle for mixed-fidelity updates."""
    rays_seq = RayBundle(points=rays_t.points[None], ds=rays_t.ds[None])
    inner_seq = (inner_bundle(rays_seq, inner_samples)
                 if inner_samples > 0 else None)
    return rays_seq, inner_seq


def _step_tensor(x, dev):
    """An epoch's draw as a (1, ...) tensor on ``dev``, or None."""
    return None if x is None else as_tensor(x, device=dev).to(dev)[None]


class _OnlineBase:
    """What both streaming filters share: configuration, the carried
    wind/cadence/noise scale, and their restart fields."""

    def __init__(self, grid: Grid3D, cov: GPCovariance, m0, wind_kmps,
                 dt_s: float, num_directions: int, i0: int, cg_iters: int,
                 cg_tol: float, fade: float, anchors, anchor_cov,
                 quadrature: str, interp: str, interp_inner: str,
                 inner_samples: int, wind_adapt_iters: int, adapt_r: float,
                 adapt_r_bounds):
        self.grid = grid
        self.cov = cov
        self.m_clim = as_tensor(m0, device=grid.device)
        self.wind = np.asarray(wind_kmps, np.float64)
        self.dt_s = float(dt_s)
        self.nd = int(num_directions)
        self.i0 = int(i0)
        self.cg_iters = int(cg_iters)
        self.cg_tol = float(cg_tol)
        self.fade = float(fade)
        # per-epoch absolute-TEC anchoring; fresh values per epoch through
        # step(anchor_values=...)
        self.anchors = anchors
        self.anchor_cov = anchor_cov
        self.quadrature = str(quadrature)
        self.interp = str(interp)
        self.interp_inner = interp_inner or None
        # >0: mixed-fidelity updates, the solve's Jacobian from every k-th
        # sample of the epoch's bundle, the misfit at full fidelity
        self.inner_samples = int(inner_samples)
        # >0: this many innovation Gauss-Newton refinements of the wind
        # before each predict; the refined wind is carried in self.wind
        # and persists through state_dict
        self.wind_adapt_iters = int(wind_adapt_iters)
        # >0: adaptive observation-noise scale S, updated from each
        # epoch's innovation-consistency MLE ρ̂² as
        # S² ← S²·((1−α) + α·ρ̂²) with α = adapt_r; S multiplies the
        # nominal noise, persists in state_dict ("r_scale") and is
        # clipped to adapt_r_bounds
        self.adapt_r = float(adapt_r)
        self.adapt_r_bounds = (float(adapt_r_bounds[0]),
                               float(adapt_r_bounds[1]))
        self.r_scale = 1.0
        self.t = 0

    def _inputs(self, d_t, noise_t, anchor_values, m_clim):
        dev = self.grid.device
        a_seq = _step_tensor(anchor_values, dev)
        clim_seq = _step_tensor(m_clim, dev)
        # the adapted scale multiplies the nominal per-epoch noise
        noise_eff = (torch.as_tensor(noise_t, dtype=torch.float32, device=dev)
                     * np.float32(self.r_scale))
        return as_tensor(d_t, device=dev).to(dev)[None], noise_eff, a_seq, \
            clim_seq

    def _finish(self, res, diag):
        """Carry the refined wind and the adapted noise scale, and add
        them to the epoch's diagnostics."""
        if self.wind_adapt_iters > 0:
            self.wind = host(res.wind_seq[0]).astype(np.float64)
            diag["wind_kmps"] = self.wind.tolist()  # nested for (2, 3) shear
        if self.adapt_r > 0.0:
            self.r_scale = _ema_scale(self.r_scale, float(res.innov_q[0]),
                                      self.adapt_r, self.adapt_r_bounds)
            diag["r_scale"] = self.r_scale
        return diag

    def _common_state(self):
        return {"t": np.int64(self.t), "wind_kmps": self.wind,
                "dt_s": np.float64(self.dt_s),
                "r_scale": np.float64(self.r_scale)}

    def _load_common(self, state):
        self.t = int(state["t"])
        self.wind = np.asarray(state["wind_kmps"])
        if "dt_s" in state:        # states written before dt_s keep theirs
            self.dt_s = float(state["dt_s"])
        if "r_scale" in state:     # the adaptive-R scale rides restarts
            self.r_scale = float(state["r_scale"])


class OnlineKalman(_OnlineBase):
    """Streaming frozen-flow Kalman filter (point estimate)."""

    def __init__(self, grid: Grid3D, cov: GPCovariance, m0, wind_kmps,
                 dt_s: float, num_directions: int, i0: int = 0,
                 cg_iters: int = 30, cg_tol: float = 1e-4,
                 fade: float = 1.0, anchors=None,
                 anchor_cov: GPCovariance = None,
                 quadrature: str = "hermite", interp: str = "cubic",
                 interp_inner: str = None,
                 inner_samples: int = 0,
                 wind_adapt_iters: int = 0,
                 adapt_r: float = 0.0,
                 adapt_r_bounds=(0.1, 30.0)):
        super().__init__(grid, cov, m0, wind_kmps, dt_s, num_directions, i0,
                         cg_iters, cg_tol, fade, anchors, anchor_cov,
                         quadrature, interp, interp_inner, inner_samples,
                         wind_adapt_iters, adapt_r, adapt_r_bounds)
        self.m = self.m_clim

    def step(self, rays_t: RayBundle, d_t, noise_t, anchor_values=None,
             m_clim=None, stats_noise=None):
        """Assimilate one epoch; returns (m_t, diag dict).

        ``anchor_values``: this epoch's absolute-TEC values for the
        configured anchors (defaults to ``anchors.values``). ``m_clim``:
        this epoch's climatological field (e.g. the Chapman background at
        the epoch's solar zenith), the fade-pull target in place of the
        bootstrap climatology. ``stats_noise`` (probes, *grid.shape) unit
        normals: the adaptive-R probes of this epoch, needed when
        ``adapt_r`` > 0 (the reference keys them by ``fold_in(0xADA0,
        t)``)."""
        rays_seq, inner_seq = _one_step(rays_t, self.inner_samples)
        d_seq, noise_eff, a_seq, clim_seq = self._inputs(
            d_t, noise_t, anchor_values, m_clim)
        adapt = self.adapt_r > 0.0
        if adapt and stats_noise is None:
            raise ValueError("OnlineKalman(adapt_r > 0).step needs "
                             "stats_noise, this epoch's probe draws")
        res = kalman_filter(
            self.grid, rays_seq, d_seq, noise_eff, self.m, self.cov,
            self.wind, self.dt_s, num_directions=self.nd, i0=self.i0,
            cg_iters=self.cg_iters, cg_tol=self.cg_tol, fade=self.fade,
            advect_first=(self.t > 0), m_clim=self.m_clim,
            anchors=self.anchors, anchor_values_seq=a_seq,
            anchor_cov=self.anchor_cov, quadrature=self.quadrature,
            interp=self.interp, interp_inner=self.interp_inner,
            m_clim_seq=clim_seq, rays_inner_seq=inner_seq,
            wind_adapt_iters=self.wind_adapt_iters,
            innov_stats=adapt,
            stats_noise=_step_tensor(stats_noise, self.grid.device)
            if adapt else None)
        self.m = res.m_seq[0]
        self.t += 1
        diag = dict(t=self.t - 1,
                    pre_residual=float(res.residuals[0]),
                    post_residual=float(res.post_residuals[0]))
        return self.m, self._finish(res, diag)

    def assimilate_probes(self, probes, cov=None, gn_iters: int = 2,
                          cg_iters: int = None, cg_tol: float = 1e-5):
        """Between-epoch sequential update from ionosonde soundings
        (``data.ionosonde.NeProbes``): point log-density rows are exactly
        linear in the state, so this is one CG-truncated Kalman update of
        the current field with the probe-specific short-vertical
        background covariance (``anchors.assimilate_probes``). Returns the
        applied log-field increment, which the serving layer folds into
        the climatology pull target."""
        from . import anchors as anchors_mod

        m_new = anchors_mod.assimilate_probes(
            self.grid, self.m, probes, cov=cov, gn_iters=gn_iters,
            cg_iters=self.cg_iters if cg_iters is None else cg_iters,
            cg_tol=cg_tol, interp=self.interp)
        delta = m_new - self.m
        self.m = m_new
        return delta

    # --- service restart ---------------------------------------------------

    def state_dict(self):
        return {"m": host(self.m), **self._common_state()}

    def load_state(self, state):
        self.m = torch.tensor(np.asarray(state["m"], np.float32),
                              device=self.grid.device)
        self._load_common(state)


class OnlineEnsembleKalman(_OnlineBase):
    """Streaming ensemble filter: current mean/spread after every epoch."""

    def __init__(self, grid: Grid3D, cov: GPCovariance, m0, wind_kmps,
                 dt_s: float, num_directions: int, n_members: int = 8,
                 i0: int = 0, cg_iters: int = 20, cg_tol: float = 1e-4,
                 fade: float = 1.0, process_sigma: float = 0.0,
                 inflation: float = 1.0, spectrum_blend: float = 0.0,
                 anchors=None, anchor_cov: GPCovariance = None,
                 quadrature: str = "hermite", interp: str = "cubic",
                 interp_inner: str = None,
                 anchor_update: str = "sqrt", inner_samples: int = 0,
                 wind_adapt_iters: int = 0,
                 adapt_r: float = 0.0,
                 adapt_r_bounds=(0.1, 30.0)):
        super().__init__(grid, cov, m0, wind_kmps, dt_s, num_directions, i0,
                         cg_iters, cg_tol, fade, anchors, anchor_cov,
                         quadrature, interp, interp_inner, inner_samples,
                         wind_adapt_iters, adapt_r, adapt_r_bounds)
        self.anchor_update = str(anchor_update)
        self.process_sigma = float(process_sigma)
        self.inflation = float(inflation)
        self.spectrum_blend = float(spectrum_blend)
        self.n_members = int(n_members)
        self.ens = None      # built by the filter on the first step

    def step(self, rays_t: RayBundle, d_t, noise_t, obs_noise,
             anchor_values=None, m_clim=None, init_noise=None,
             process_noise=None, anchor_noise=None):
        """Assimilate one epoch; returns (mean, std, diag dict).

        This epoch's draws, unit normals: ``obs_noise`` (B, Na·Nd);
        ``init_noise`` (B, *grid.shape) for the initial ensemble, needed
        at the first step; ``process_noise`` (B, *grid.shape) when
        ``process_sigma`` > 0; ``anchor_noise`` (B, A) for
        ``anchor_update="stochastic"``. ``anchor_values``, ``m_clim``: as
        for ``OnlineKalman.step``. The adaptive noise scale needs no
        probes here: diag(H P_f Hᵀ) is the spread of the member
        forwards."""
        dev = self.grid.device
        rays_seq, inner_seq = _one_step(rays_t, self.inner_samples)
        d_seq, noise_eff, a_seq, clim_seq = self._inputs(
            d_t, noise_t, anchor_values, m_clim)
        adapt = self.adapt_r > 0.0
        # this epoch's draws sit at index 0 of one-step sequences
        res = ensemble_kalman_filter(
            self.grid, rays_seq, d_seq, noise_eff, self.m_clim, self.cov,
            self.wind, self.dt_s, num_directions=self.nd,
            obs_noise=_step_tensor(obs_noise, dev),
            n_members=self.n_members, i0=self.i0, cg_iters=self.cg_iters,
            cg_tol=self.cg_tol, fade=self.fade,
            process_sigma=self.process_sigma,
            process_noise=_step_tensor(process_noise, dev),
            advect_first=(self.t > 0), m_clim=self.m_clim,
            inflation=self.inflation, ens0=self.ens,
            init_noise=(None if init_noise is None
                        else as_tensor(init_noise, device=dev).to(dev)),
            step_offset=0, spectrum_blend=self.spectrum_blend,
            anchors=self.anchors, anchor_values_seq=a_seq,
            anchor_cov=self.anchor_cov, anchor_update=self.anchor_update,
            anchor_noise=_step_tensor(anchor_noise, dev),
            quadrature=self.quadrature, interp=self.interp,
            interp_inner=self.interp_inner, m_clim_seq=clim_seq,
            rays_inner_seq=inner_seq,
            wind_adapt_iters=self.wind_adapt_iters, innov_stats=adapt)
        self.ens = res.ensemble
        self.t += 1
        diag = dict(t=self.t - 1, pre_residual=float(res.residuals[0]))
        return res.mean_seq[0], res.std_seq[0], self._finish(res, diag)

    def assimilate_probes(self, probes, cov=None, cg_iters: int = None,
                          cg_tol: float = 1e-5):
        """Between-epoch square-root ensemble update from ionosonde
        soundings (``anchors.probe_sqrt_update``: deterministic, so the
        streaming restart identity is kept). Before the first epoch the
        ensemble does not exist yet; the serving layer holds sounding
        files until ``t > 0``. Returns the ensemble-mean increment."""
        from . import anchors as anchors_mod

        if self.ens is None:
            raise RuntimeError(
                "assimilate_probes before the first epoch: the ensemble "
                "is built by the first step(); hold the sounding until "
                "an epoch has been assimilated")
        mean0 = self.ens.mean(0)
        self.ens = anchors_mod.probe_sqrt_update(
            self.grid, self.ens, probes, cov=cov,
            cg_iters=self.cg_iters if cg_iters is None else cg_iters,
            cg_tol=cg_tol, interp=self.interp)
        return self.ens.mean(0) - mean0

    def state_dict(self):
        return {"ensemble": host(self.ens), **self._common_state()}

    def load_state(self, state):
        self.ens = torch.tensor(np.asarray(state["ensemble"], np.float32),
                                device=self.grid.device)
        self._load_common(state)
