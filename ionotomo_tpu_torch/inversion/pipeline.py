"""End-to-end batch inversion pipeline on one device (port of
``ionotomo_tpu.inversion.pipeline``; SURVEY.md §3.1).

Host shell around the device core: accept a DataPack → build the initial
model (a grid sized to enclose all rays, the Chapman prior) → per
timestep: rays (straight or bent) → solve (MAP Gauss-Newton, robust IRLS,
LSQR, steepest descent, batched snapshots, or the Kalman / ensemble
filters over the whole sequence) → Solution + atomic checkpoints + JSONL
metrics. The solves and filters read nothing back from the card inside
their loops; the host orchestrates set-up, checkpointing and logging.

    pipe = InversionPipeline(datapack, config)   # device: the card
    sol = pipe.run(resume=True)

The mesh (``parallel.sharding``): the pipeline attaches ``ray_mesh()``
when it runs on the card and more than one card is visible, as the
reference attaches one over its devices, and takes an explicit ``mesh=``
(S shards on one device, as the tests and ``chip_smoke.py`` run them).
With a mesh, the antennas are padded to a multiple of its size (whole
antennas: the last repeated, observations 0, noise 1e6, logged once as a
``ray_sharding_padded`` event), and the snapshot solves and the filters'
chunks run on ray-sharded bundles (``parallel.sharding.ShardedRayBundle``,
the operators ``ShardedPairedDtecLinear``); ``solver.enkf_shard=
"members"`` runs the ensemble filter member-parallel instead
(``kalman.member_parallel_enkf``, the bundles whole). The prior selection,
the profile estimate, the posterior draws, the batched mode and the
chunk-boundary diagnostics take the padded bundle whole on the first
device. Without a mesh nothing is padded or sharded. A snapshot solve
builds the geometry of its bundle once and drops it after the solve; the
filters build one per step of a chunk (``kalman._Geometries``).

Randomness (beam-noise jitter, posterior draws, the ensemble's draws, the
spectrum diagnostic's start block, the GCV probes) is drawn by
``draw_normals`` and ``draw_signs`` from CPU generators keyed by (the
run's seed, a constant for each use, the global timestep) through
``utils.draws``, so chunked, resumed and
uninterrupted runs draw alike on every device. The reference keys the
same uses by its PRNG keys; a subclass may override the two methods (the
parity tests feed the reference's own draws through them).

Checkpoints have the reference's keys (``m_seq``, ``m_std``,
``kalman_pre``, ``kalman_post``, ``wind_kmps``, ``noise_scale``,
``enkf_ensemble``, ``enkf_std``) and config JSON, so either package
resumes the other's checkpoint (``convert.pipeline_checkpoint_from_numpy``
reads one as numpy).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import EngineConfig, resumable
from ..convert import pipeline_checkpoint_from_numpy
from ..data.datapack import DataPack
from ..device import as_tensor, host, resolve
from ..geometry import fermat, rays as rays_mod
from ..models import chapman
from ..utils import checkpoint as ckpt_mod
from ..utils.draws import (DRAW_ENKF_ANCHOR, DRAW_ENKF_INIT, DRAW_ENKF_OBS,
                           DRAW_ENKF_PROCESS, DRAW_SPECTRUM, normals,
                           rademacher)
from ..utils.metrics import MetricsWriter
from . import solvers
from ..parallel import sharding as shard_mod
from .kalman import (ensemble_kalman_filter, initial_ensemble, kalman_filter,
                     member_parallel_enkf)
from .model_selection import DRAW_GCV
from .priors import GPCovariance
from .solution import Solution

#: The constants that key the pipeline's own draws (with the seed and the
#: timestep): the reference's ``fold_in`` offsets of the same uses.
DRAW_BEAM = 9000017             # beam-noise jitter
DRAW_POSTERIOR_DATA = 1000003   # posterior draws: the data perturbations
DRAW_POSTERIOR_PRIOR = 1000004  # posterior draws: the prior perturbations


class InversionPipeline:
    """Drives a full reconstruction from a DataPack on ``device`` (the card
    unless named). ``mesh``: the device mesh the rays shard over (default:
    ``ray_mesh()`` when the device is a card and more than one is visible,
    else none)."""

    def __init__(self, datapack: DataPack, config: EngineConfig = None,
                 device=None, mesh=None):
        self.device = resolve(device)
        if mesh is None and self.device.type == "cuda" \
                and torch.cuda.device_count() > 1:
            mesh = shard_mod.ray_mesh()
        self.mesh = mesh
        self._na_padded = None        # lazy; see _padded_na
        self.datapack = datapack
        self.config = config or EngineConfig()
        self.metrics = MetricsWriter(self.config.runtime.metrics_path)
        dev = self.datapack.to_device_arrays()
        self.antennas = dev["antennas_enu"]
        self.directions = dev["directions_enu"]      # (Nt, Nd, 3)
        self.d_obs = dev["dtec"]                      # (Na, Nt, Nd)
        # flagged samples are soft-masked by noise inflation (their weight
        # in every C_d^-1-weighted misfit becomes ~0, shapes stay static)
        self.noise_std = np.where(dev["flags"], np.float32(1e6),
                                  dev["noise_std"])
        self.i0 = dev["ref_antenna"]
        self.grid = chapman.grid_enclosing_rays(
            self.antennas, self.directions.reshape(-1, 3),
            max_length_km=self.config.physics.max_length_km,
            shape=self.config.grid.shape,
            pad_km=self.config.grid.pad_km,
            h_min_km=self.config.grid.h_min_km, device=self.device)
        self.m_prior = self._clim_field(self.datapack.times.mean())
        # the pristine prior: run() restores it, so repeated runs (with or
        # without anchors) equal fresh-pipeline runs
        self._m_prior0 = self.m_prior
        pr = self.config.prior
        self.cov = GPCovariance.create(self.grid, sigma=pr.sigma,
                                       length_scale=pr.length_scale_km,
                                       kind=pr.kind)
        self.anchors = None            # TecAnchors via run(anchors=...)
        self.anchor_cov = None         # background-error covariance
        self._profile_theta = None     # θ̂ from estimate_profile, per run
        self._profile_build = None     # its θ → field builder
        if pr.auto_select:
            self._auto_select_prior()

    # --- draws -------------------------------------------------------------

    def draw_normals(self, use: int, index: int, shape) -> torch.Tensor:
        """Standard normals for one use at one global timestep, on the
        pipeline's device (module docstring)."""
        return normals(self.config.runtime.seed, use, index,
                       shape).to(self.device)

    def draw_signs(self, use: int, index: int, shape) -> torch.Tensor:
        """Rademacher probes (±1) for one use, keyed as ``draw_normals``."""
        return rademacher(self.config.runtime.seed, use, index,
                          shape).to(self.device)

    # --- the prior ---------------------------------------------------------

    def _clim_field(self, mjd: float) -> torch.Tensor:
        """Climatological log-density field at epoch time ``mjd``: the
        a-priori model (Chapman or multi-Chapman, flat or curved Earth)
        modulated by the solar zenith at that instant. The run's prior (at
        the observation midpoint) and, with ``physics.time_varying_clim``,
        the filters' per-epoch fade-pull target."""
        from ..geometry import frames

        p = self.config.physics
        enu_frame = self.datapack.array.enu_frame
        r_earth = None
        if p.curved_earth:
            r_earth = frames.gaussian_earth_radius(enu_frame.lat)
            cos_chi = chapman.terminator_cos_chi(self.grid, enu_frame, mjd)
        else:
            cos_chi = float(frames.solar_cos_zenith(mjd, enu_frame))
        if p.apriori_model == "multi_chapman":
            ne0 = chapman.multi_chapman_field(
                self.grid, cos_chi=cos_chi,
                plasmasphere_n0=p.plasmasphere_n0,
                curved=p.curved_earth, earth_radius_km=r_earth)
        else:
            ne0 = chapman.chapman_field(self.grid, n_peak=p.chapman_n_peak,
                                        h_peak_km=p.chapman_h_peak_km,
                                        scale_km=p.chapman_scale_km,
                                        cos_chi=cos_chi,
                                        curved=p.curved_earth,
                                        earth_radius_km=r_earth)
        return chapman.log_parametrize(ne0)

    def _clim_seq(self, c0: int, c1: int):
        """(c1-c0, *grid.shape) per-epoch climatological fields for the
        filters, or None when ``time_varying_clim`` is off. After
        ``estimate_profile`` the target is the estimated profile modulated
        by the solar factor relative to timestep 0, so the fade pull does
        not drag the state back to the configured climatology."""
        if not self.config.physics.time_varying_clim:
            return None
        if self._profile_theta is None:
            return torch.stack([self._clim_field(float(self.datapack.times[t]))
                                for t in range(c0, c1)])
        from ..geometry import frames

        enu_frame = self.datapack.array.enu_frame

        def factor(t):
            cos = frames.solar_cos_zenith(float(self.datapack.times[t]),
                                          enu_frame)
            return float(chapman.solar_zenith_factor(
                torch.tensor(np.float32(cos))))
        base = self._profile_build(self._profile_theta)
        f_ref = factor(0)
        return torch.stack([
            base + torch.log(torch.tensor(np.float32(factor(t) / f_ref)))
            .to(self.device) for t in range(c0, c1)])

    def _estimate_profile(self, anchors, probes=None):
        """The joint (θ, δm) MAP solve on timestep-0 data + anchors (+
        probe rows), installing the estimated profile as the run's prior
        mean (``inversion.profile``). θ is the single Chapman layer, or
        with ``apriori_model="multi_chapman"`` the flat per-layer vector of
        the E/F1/F2 stack, each layer's prior std scaled by its thickness
        relative to the thickest. θ̂ goes to the metrics stream."""
        from .profile import (ProfileParams, chapman_log_field,
                              map_gauss_newton_profile,
                              multi_chapman_log_field)

        p, sc = self.config.physics, self.config.solver
        curved = bool(p.curved_earth)
        grid = self.grid
        if p.apriori_model == "multi_chapman":
            if p.plasmasphere_n0:
                raise ValueError(
                    "estimate_profile with a plasmasphere tail is not "
                    "supported (the tail is not part of the θ "
                    "parametrization); set plasmasphere_n0=0 or call "
                    "inversion.profile.map_gauss_newton_profile with a "
                    "custom field_builder")
            layers = chapman.DEFAULT_LAYERS
            theta0 = torch.tensor([v for (_, n, h, s, _) in layers
                                   for v in (float(np.log(n)), h, s)],
                                  dtype=torch.float32, device=self.device)
            scales = [s for (_, _, _, s, _) in layers]
            s_max = max(scales)
            sigma = tuple(base * s / s_max
                          for s in scales for base in sc.profile_sigma)

            def build(t):
                return multi_chapman_log_field(grid, t, curved=curved)
        else:
            theta0 = ProfileParams.create(n_peak=p.chapman_n_peak,
                                          h_peak_km=p.chapman_h_peak_km,
                                          scale_km=p.chapman_scale_km,
                                          device=self.device)
            sigma = sc.profile_sigma

            def build(t):
                return chapman_log_field(
                    grid, ProfileParams(t[0], t[1], t[2]), curved=curved)
        nd = self.directions.shape[1]
        ants, d0, noise0, _ = self._padded_data(0)
        rb = self.rays_for_time(0, antennas=ants)
        res = map_gauss_newton_profile(
            grid, rb, d0, noise0, theta0, sigma, self.cov,
            num_directions=nd, anchors=anchors, i0=self.i0,
            gn_iters=max(sc.gn_iters, 4), cg_iters=sc.cg_iters,
            quadrature=self.config.rays.quadrature,
            interp=self.config.rays.interp, field_builder=build,
            probes=probes)
        theta_flat = (torch.stack([res.theta.log_n_peak,
                                   res.theta.h_peak_km, res.theta.scale_km])
                      if isinstance(res.theta, ProfileParams)
                      else res.theta)
        self.m_prior = build(theta_flat)
        self._profile_theta = theta_flat
        self._profile_build = build
        ev = dict(event="profile_estimated",
                  residual=float(res.residual_norm))
        if isinstance(res.theta, ProfileParams):
            ev.update(n_peak=float(res.theta.n_peak),
                      h_peak_km=float(res.theta.h_peak_km),
                      scale_km=float(res.theta.scale_km))
        else:
            t = host(theta_flat).astype(np.float64)
            ev["layers"] = [dict(n_peak=float(np.exp(t[3 * i])),
                                 h_peak_km=float(t[3 * i + 1]),
                                 scale_km=float(t[3 * i + 2]))
                            for i in range(t.size // 3)]
        self.metrics.write(ev)

    def _straight_bundle_0(self):
        """Timestep 0's data and its straight rays (prior selection)."""
        ants, d0, noise0, _ = self._padded_data(0)
        origins, dvecs = rays_mod.make_ray_batch(
            ants, as_tensor(self.directions[0], device=self.device))
        rb = rays_mod.sample_straight_rays(
            origins, dvecs, max_length_km=self.config.physics.max_length_km,
            n_samples=self.config.rays.n_samples)
        return rb, d0, noise0

    def _auto_select_prior(self):
        """Data-driven prior hyperparameters at set-up, scored on timestep-0
        data with straight rays; the winner becomes the run's covariance,
        choice and scores logged. ``auto_select="gcv"`` (or True):
        generalised cross-validation over a candidate grid
        (``inversion.model_selection``); ``"evidence"``: the marginal
        likelihood (``inversion.empirical_bayes``)."""
        from .model_selection import select_prior

        pr = self.config.prior
        method = (pr.auto_select if isinstance(pr.auto_select, str)
                  else ("gcv" if pr.auto_select else "off"))
        if method == "evidence":
            return self._auto_select_prior_evidence()
        candidates = []
        ls0 = pr.length_scale_km
        for kind in dict.fromkeys([pr.kind, "von_karman", "exponential"]):
            for fs in (0.5, 1.0, 2.0):
                for fl in (0.5, 1.0, 2.0):
                    ls = (tuple(v * fl for v in ls0)
                          if isinstance(ls0, (tuple, list)) else ls0 * fl)
                    candidates.append(dict(
                        sigma=pr.sigma * fs, length_scale=ls, kind=kind))
        rb, d0, noise0 = self._straight_bundle_0()
        probes = self.draw_signs(DRAW_GCV, 0, (4, d0.numel()))
        cov, params, scores = select_prior(
            self.grid, rb, d0, noise0, self.m_prior, candidates,
            num_directions=self.directions.shape[1], probes=probes,
            i0=self.i0, cg_iters=self.config.solver.cg_iters)
        self.cov = cov
        self.metrics.write(dict(event="prior_auto_selected",
                                chosen=params,
                                n_candidates=len(candidates),
                                best_score=float(min(scores))))

    def _auto_select_prior_evidence(self):
        """Marginal-likelihood (σ, L, kind[, ρ]) fit on timestep-0 data:
        L and kind candidates around the configured prior, the σ axis (and
        with ``prior.fit_noise`` the noise-rescaling ρ axis) a dense log
        grid priced from each factorisation. A fitted ρ* rescales the
        run's noise_std (flag-inflated entries stay effectively
        infinite)."""
        from .empirical_bayes import fit_hyperparameters

        pr = self.config.prior
        ls0 = pr.length_scale_km
        l_base = (float(np.mean(ls0)) if isinstance(ls0, (tuple, list))
                  else float(ls0))
        ells = [l_base * f for f in (0.5, 1.0, 2.0)]
        sigmas = pr.sigma * np.logspace(-0.9, 0.9, 9)
        rhos = np.logspace(-0.6, 0.6, 7) if pr.fit_noise else None
        rb, d0, noise0 = self._straight_bundle_0()
        best = None
        for kind in dict.fromkeys([pr.kind, "von_karman", "exponential"]):
            fit = fit_hyperparameters(
                self.grid, rb, d0, noise0, self.m_prior,
                num_directions=self.directions.shape[1],
                length_scales=ells, sigmas=sigmas, kind=kind, i0=self.i0,
                quadrature=self.config.rays.quadrature,
                interp=self.config.rays.interp,
                seed=self.config.runtime.seed, noise_scales=rhos)
            if rhos is None:
                s_star, l_star, table, cov_star = fit
                rho_star = 1.0
            else:
                s_star, l_star, rho_star, table, cov_star = fit
            ll = float(table.max())
            if best is None or ll > best[0]:
                best = (ll, s_star, l_star, rho_star, kind, cov_star)
        ll, s_star, l_star, rho_star, kind, cov_star = best
        self.cov = cov_star
        if pr.fit_noise:
            self.noise_std = self.noise_std * rho_star
        self.metrics.write(dict(
            event="prior_auto_selected", method="evidence",
            chosen=dict(sigma=s_star, length_scale=l_star, kind=kind,
                        noise_scale=rho_star),
            log_evidence=ll))

    # --- ray building --------------------------------------------------------

    def rays_for_time(self, t: int, m_field=None, antennas=None):
        """RayBundle for timestep t; bent rays trace through ``m_field``
        (the prior model by default) when ``config.rays.bent``.
        ``antennas`` overrides the antenna set."""
        ants = self.antennas if antennas is None else antennas
        origins, dvecs = rays_mod.make_ray_batch(
            as_tensor(ants, device=self.device),
            as_tensor(self.directions[t], device=self.device))
        rc, p = self.config.rays, self.config.physics
        if rc.bent:
            field = self.m_prior if m_field is None else m_field
            bundle, _ = fermat.trace_rays(
                field, self.grid, origins, dvecs,
                self.datapack.frequency_hz, p.max_length_km,
                n_steps=rc.n_steps, keep_path=True, method=rc.method,
                interp=rc.interp)
            return bundle
        return rays_mod.sample_straight_rays(
            origins, dvecs, max_length_km=p.max_length_km,
            n_samples=rc.n_samples)

    def _inner(self, bundle):
        """Coarse companion bundle for mixed-fidelity solves
        (``rays.inner_samples`` > 0), or None."""
        k = self.config.rays.inner_samples
        return rays_mod.inner_bundle(bundle, k) if k > 0 else None

    # --- sharding ------------------------------------------------------------

    def _padded_na(self, na: int) -> int:
        """Smallest Na' ≥ Na divisible by the mesh size: every shard holds
        whole antennas. Rays are padded in whole-antenna blocks (the last
        antenna repeated, observations zero with noise 1e6, a weight of
        ~1e-12 in every C_d⁻¹ misfit). Depends only on (Na, mesh): computed
        and logged once."""
        if self.mesh is None:
            return na
        if self._na_padded is None:
            k = self.mesh.size
            na_p = shard_mod.pad_to_multiple(na, k)
            self._na_padded = na_p
            if na_p != na:
                self.metrics.write(dict(event="ray_sharding_padded",
                                        na=na, na_padded=na_p, devices=k))
        return self._na_padded

    def _shard(self, bundle):
        """The bundle's ray axis sharded over the mesh (callers pad whole
        antennas first, so the ray count divides the mesh size); the
        bundle itself without a mesh."""
        if self.mesh is None:
            return bundle
        assert bundle.num_rays % self.mesh.size == 0
        return shard_mod.shard_rays(self.mesh, bundle)

    def _chunk_arrays(self, c0: int, c1: int, shard: bool = True):
        """The filters' per-timestep arrays for timesteps [c0, c1): (rays
        with a leading time axis, their inner bundle or None, d (n, Na,
        Nd), noise (n, Na, Nd)), padded, the rays sharded along axis 1
        over the mesh unless ``shard=False`` (the member-parallel ensemble
        shards its members instead)."""
        per = [self._padded_data(t) for t in range(c0, c1)]
        bundles = [self.rays_for_time(t, antennas=per[i][0])
                   for i, t in enumerate(range(c0, c1))]
        rays_seq = rays_mod.RayBundle(
            points=torch.stack([b.points for b in bundles]),
            ds=torch.stack([b.ds for b in bundles]))
        if self.mesh is not None and shard:
            rays_seq = shard_mod.shard_rays(self.mesh, rays_seq, ray_axis=1)
        d = torch.stack([p[1] for p in per])
        noise = torch.stack([p[2] for p in per])
        return rays_seq, self._inner(rays_seq), d, noise

    def _padded_data(self, t: int):
        """(antennas, d_t, noise_t, na_real) for timestep t on the device,
        with the whole-antenna padding of ``_padded_na`` under a mesh.
        With ``rays.beam_noise > 0`` the noise is inflated in quadrature
        with the epoch's chaotic beam spread."""
        na, nd = self.d_obs.shape[0], self.directions.shape[1]
        na_p = self._padded_na(na)
        ants = as_tensor(self.antennas, device=self.device)
        d_t = as_tensor(np.asarray(self.d_obs[:, t, :]), device=self.device)
        noise = as_tensor(np.asarray(self.noise_std[:, t, :]),
                          device=self.device)
        if na_p != na:
            pad = na_p - na
            ants = torch.cat([ants, ants[-1:].expand(pad, 3)])
            d_t = torch.cat([d_t, torch.zeros((pad, nd), dtype=d_t.dtype,
                                              device=d_t.device)])
            noise = torch.cat([noise, torch.full((pad, nd), 1e6,
                                                 dtype=noise.dtype,
                                                 device=noise.device)])
        if self.config.rays.beam_noise > 0:
            infl = self._beam_inflation(t, ants)
            noise = torch.sqrt(noise * noise + infl * infl)
        return ants, d_t, noise, na

    def _beam_inflation(self, t: int, ants):
        """Strong-turbulence observation-noise inflation for timestep t:
        the chaotic dTEC spread of a stochastic Fresnel beam traced through
        the prior field (``geometry.fermat.beam_noise_for_epoch``). Drawn
        from (seed, ``DRAW_BEAM``, t), so chunked and resumed runs inflate
        bit-identically; the spread is logged per epoch. The prior is the
        linearisation point: the error bar stays fixed across Gauss-Newton
        iterates."""
        rc, p = self.config.rays, self.config.physics
        n_rays = ants.shape[0] * self.directions.shape[1]
        noise = self.draw_normals(DRAW_BEAM, t,
                                  (rc.beam_noise - 1, n_rays, 2))
        infl = fermat.beam_noise_for_epoch(
            self.m_prior, self.grid, ants, self.directions[t],
            self.datapack.frequency_hz, noise, n_paths=rc.beam_noise,
            i0=self.i0, jitter_rad=(rc.beam_jitter_rad or None),
            max_length_km=p.max_length_km, n_steps=rc.n_steps,
            method=rc.method, interp=rc.interp)
        self.metrics.write(dict(
            event="beam_noise", t=t, n_paths=rc.beam_noise,
            mean=float(torch.mean(infl)), max=float(torch.max(infl))))
        return infl

    # --- solving -------------------------------------------------------------

    def _solve_once(self, rb, d_t, noise, m_start, nd, m0=None):
        sc = self.config.solver
        quad = self.config.rays.quadrature
        itp = self.config.rays.interp
        itp_in = self.config.rays.interp_inner or None
        if sc.solver == "lsqr_smoothness":
            return solvers.lsqr_smoothness(
                self.grid, rb, d_t, noise, m_start, num_directions=nd,
                i0=self.i0, damp=self.config.prior.damp,
                smooth=self.config.prior.smooth, max_iters=sc.lsqr_iters,
                quadrature=quad, interp=itp)
        if sc.solver == "robust_gn":
            return solvers.map_gauss_newton_robust(
                self.grid, rb, d_t, noise, m_start, self.cov,
                num_directions=nd, i0=self.i0, gn_iters=sc.gn_iters,
                cg_iters=sc.cg_iters, cg_tol=sc.cg_tol,
                huber_k=sc.huber_k, irls_iters=sc.irls_iters,
                quadrature=quad, interp=itp, rays_inner=self._inner(rb),
                warm_start=sc.warm_start, interp_inner=itp_in)
        if sc.solver == "steepest":
            return solvers.steepest_descent_map(
                self.grid, rb, d_t, noise, m_start, self.cov,
                num_directions=nd, i0=self.i0, n_iters=sc.gn_iters * 8)
        return solvers.map_gauss_newton(
            self.grid, rb, d_t, noise, m_start, self.cov,
            num_directions=nd, i0=self.i0, gn_iters=sc.gn_iters,
            cg_iters=sc.cg_iters, cg_tol=sc.cg_tol, m0=m0,
            anchors=self.anchors, quadrature=quad, interp=itp,
            rays_inner=self._inner(rb), warm_start=sc.warm_start,
            interp_inner=itp_in)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def solve_snapshot(self, t: int, m0=None):
        """Invert one timestep; returns (m, diagnostics dict).

        With bent rays and ``rays.retrace_every > 0`` the rays are
        re-traced through the current iterate every ``retrace_every``
        Gauss-Newton iterations and the solve continues from it (the
        reference's calc_rays ↔ solve alternation), stopping early when the
        whitened residual stalls (<1 % improvement).
        """
        sc, rc = self.config.solver, self.config.rays
        nd = self.directions.shape[1]
        ants, d_t, noise, na_real = self._padded_data(t)
        m_start = self.m_prior if m0 is None else m0
        retrace = (rc.bent and rc.retrace_every > 0
                   and sc.solver == "map_gauss_newton" and sc.gn_iters > 0)
        self._sync()
        t0 = time.perf_counter()
        if not retrace:
            rb = self._shard(self.rays_for_time(t, antennas=ants))
            res = self._solve_once(rb, d_t, noise, m_start, nd, m0=m0)
            retraces = 0
        else:
            m_k, prev_res, res = m_start, float("inf"), None
            done_iters, retraces, u_carry = 0, 0, None
            while done_iters < sc.gn_iters:
                rb = self._shard(self.rays_for_time(t, m_field=m_k,
                                                    antennas=ants))
                if done_iters > 0:
                    retraces += 1
                n_iters = min(rc.retrace_every, sc.gn_iters - done_iters)
                res = solvers.map_gauss_newton(
                    self.grid, rb, d_t, noise, m_start, self.cov,
                    num_directions=nd, i0=self.i0, gn_iters=n_iters,
                    cg_iters=sc.cg_iters, cg_tol=sc.cg_tol, m0=m_k,
                    anchors=self.anchors, quadrature=rc.quadrature,
                    interp=rc.interp, rays_inner=self._inner(rb),
                    warm_start=sc.warm_start, u0=u_carry,
                    interp_inner=rc.interp_inner or None)
                # same data, re-traced paths: the whitened departure keeps
                # its meaning across calls
                u_carry = res.u_final
                m_k = res.m
                done_iters += n_iters
                cur = float(res.residual_norm)   # the outer stall check
                if prev_res - cur < 0.01 * prev_res:
                    break
                prev_res = cur
        n_rays = rb.num_rays
        residual = float(res.residual_norm)
        self._sync()
        dt = time.perf_counter() - t0
        diag = dict(timestep=t, seconds=dt, residual=residual,
                    solver=sc.solver, rays=int(min(n_rays, na_real * nd)),
                    retraces=retraces, rays_per_sec=n_rays / dt,
                    iters_per_sec=(sc.gn_iters / dt
                                   if sc.solver == "map_gauss_newton"
                                   else None))
        return res.m, diag

    def posterior_std(self, t: int, n_samples: int, m_field=None):
        """Per-voxel posterior std at timestep t from ``n_samples``
        linearised-posterior RTO draws (``solvers.posterior_samples``, one
        batched CG), drawn from (seed, ``DRAW_POSTERIOR_*``, t). With bent
        rays pass the converged field as ``m_field`` so J is linearised
        along the solved-through paths. Joint-mode anchors join the draws
        as extra rows."""
        sc, rc = self.config.solver, self.config.rays
        nd = self.directions.shape[1]
        ants, d_t, noise, _ = self._padded_data(t)
        rb = self.rays_for_time(t, m_field=(m_field if rc.bent else None),
                                antennas=ants)
        n_data = d_t.numel() + (0 if self.anchors is None
                                else self.anchors.values.numel())
        eps = self.draw_normals(DRAW_POSTERIOR_DATA, t, (n_samples, n_data))
        eta = self.draw_normals(DRAW_POSTERIOR_PRIOR, t,
                                (n_samples,) + tuple(self.grid.shape))
        _, _, std = solvers.posterior_samples(
            self.grid, rb, d_t, noise, self.m_prior, self.cov,
            num_directions=nd, data_noise=eps, prior_noise=eta, i0=self.i0,
            cg_iters=sc.cg_iters, cg_tol=sc.cg_tol, anchors=self.anchors,
            quadrature=rc.quadrature, interp=rc.interp)
        return std

    def _fit_noise_scale(self, t: int, m_lin, scale: float) -> float:
        """One online noise-adaptation event (``solver.noise_adapt_every``):
        the exact dense (γ, ρ) evidence family on timestep t's innovation,
        linearised about the current filter state, with the run's
        covariance as the prior hypothesis. Returns the multiplicative
        correction to the current scale."""
        from .empirical_bayes import log_marginal_family

        nd = self.directions.shape[1]
        ants, d_t, noise, _ = self._padded_data(t)
        rb = self.rays_for_time(t, antennas=ants)
        cov1 = GPCovariance.create(self.grid, sigma=1.0,
                                   length_scale=self.cov.length_scale,
                                   kind=self.cov.kind)
        gammas = (self.cov.sigma * np.logspace(-0.6, 0.6, 9)) ** 2
        rhos = np.logspace(-0.6, 0.6, 9)
        ll, _ = log_marginal_family(
            self.grid, rb, d_t, noise * scale, m_lin, cov1,
            gammas.astype(np.float32), nd, i0=self.i0,
            quadrature=self.config.rays.quadrature,
            interp=self.config.rays.interp,
            noise_scales=rhos.astype(np.float32), method="dense")
        _, i_r = np.unravel_index(int(np.argmax(ll)), ll.shape)
        return float(rhos[i_r])

    def _diag_spectrum(self, t: int, m_lin, noise_scale: float) -> None:
        """One update-operator conditioning diagnostic
        (``solver.diag_spectrum_every``): the randomized top-rank spectrum
        of I + C^½JᵀC_d⁻¹JC^½ at the current filter state on timestep t's
        rays, logged as an ``update_spectrum`` event. λ₁ is the operator's
        condition-number bound."""
        from .kalman import update_operator_eigs

        sc = self.config.solver
        nd = self.directions.shape[1]
        ants, _, noise, _ = self._padded_data(t)
        rb = self.rays_for_time(t, antennas=ants)
        rank = min(sc.diag_spectrum_rank, self.grid.num_voxels)
        z = self.draw_normals(DRAW_SPECTRUM, t,
                              (self.grid.num_voxels, rank + 8))
        _, lam = update_operator_eigs(
            self.grid, rb, noise * noise_scale, m_lin, self.cov, nd, z,
            rank=rank, i0=self.i0, quadrature=self.config.rays.quadrature,
            interp=self.config.rays.interp)
        lam = [float(v) for v in host(lam)]
        self.metrics.write(dict(event="update_spectrum", t=t, rank=rank,
                                lam=lam, kappa_bound=lam[0]))

    def anchor_background_cov(self, sigma: float = 1.0,
                              vertical_scale_km: float = 150.0
                              ) -> GPCovariance:
        """Background-error covariance for sequential VTEC assimilation
        (``inversion.anchors.background_covariance``)."""
        from .anchors import background_covariance
        return background_covariance(self.grid, sigma=sigma,
                                     vertical_scale_km=vertical_scale_km)

    def run(self, resume: bool = True, anchors=None,
            anchor_mode: str = "sequential", anchor_cov=None,
            probes=None) -> Solution:
        """Full run: all timesteps, checkpointed, metrics-logged. With
        ``runtime.profile_dir`` set, the run is captured as a
        ``torch.profiler`` trace there (``utils.metrics.profile_to``).

        ``anchors`` (``inversion.anchors.TecAnchors``): external
        absolute-TEC constraints. ``anchor_mode="sequential"`` (default)
        assimilates them into the prior mean once, before the dTEC solves
        (the filters also re-anchor every epoch); ``"joint"`` appends them
        as data rows of each MAP Gauss-Newton snapshot solve.
        ``anchor_cov``: the background-error covariance they correct
        (default ``anchor_background_cov()``).

        ``probes`` (``data.ionosonde.NeProbes``): ionosonde point-density
        rows. With ``estimate_profile`` they join the joint (θ, δm) solve;
        otherwise they are assimilated into the prior mean after the
        anchors (``inversion.anchors.assimilate_probes``).
        """
        # anchor state never leaks between run() calls: a later
        # run(anchors=None) equals a fresh pipeline's run
        self.anchors, self.anchor_cov = None, None
        self._profile_theta, self._profile_build = None, None
        self.m_prior = self._m_prior0
        solver_name = self.config.solver.solver
        if anchors is not None:
            from . import anchors as anchors_mod
            if anchor_mode == "joint" and solver_name != "map_gauss_newton":
                raise ValueError(
                    f"anchor_mode='joint' supports only the "
                    f"map_gauss_newton solver (got '{solver_name}'): the "
                    "other modes would silently ignore the anchors — use "
                    "anchor_mode='sequential', which works with every "
                    "solver (and re-anchors per epoch in kalman mode)")
            if anchor_mode == "joint" and self.config.solver.estimate_profile:
                raise ValueError(
                    "solver.estimate_profile requires "
                    "anchor_mode='sequential': the profile solve consumes "
                    "the anchors up front and installs the estimated "
                    "profile as the prior; with 'joint' it would be "
                    "silently skipped")
            self.metrics.write(dict(event="tec_anchors", mode=anchor_mode,
                                    n=int(anchors.values.shape[0])))
            self.anchor_cov = anchor_cov or self.anchor_background_cov()
            if anchor_mode == "sequential":
                if self.config.solver.estimate_profile:
                    # the parametric profile estimate replaces the
                    # fixed-profile anchor assimilation
                    self._estimate_profile(anchors, probes)
                else:
                    # the run's (quadrature, interp) thread through, so
                    # the anchor fit uses the solves' discretization
                    self.m_prior = anchors_mod.assimilate_anchors(
                        self.grid, self.m_prior, self.anchor_cov, anchors,
                        quadrature=self.config.rays.quadrature,
                        interp=self.config.rays.interp)
                if solver_name in ("kalman", "enkf"):
                    # time-evolving runs re-anchor every epoch
                    self.anchors = anchors
            else:
                self.anchors = anchors
        elif self.config.solver.estimate_profile:
            raise ValueError(
                "solver.estimate_profile needs absolute-TEC anchors "
                "(run(anchors=...)): the profile shape is unobservable "
                "from dTEC alone; provide multi-elevation slant anchors "
                "(inversion.anchors.slant_bundle)")
        if probes is not None:
            self.metrics.write(dict(event="ionosonde_probes",
                                    n=int(probes.values.shape[0])))
            if not self.config.solver.estimate_profile:
                from .anchors import assimilate_probes
                self.m_prior = assimilate_probes(
                    self.grid, self.m_prior, probes,
                    interp=self.config.rays.interp)
        rt = self.config.runtime
        if rt.profile_dir:
            from ..utils.metrics import profile_to
            with profile_to(rt.profile_dir):
                return self._run_inner(resume)
        return self._run_inner(resume)

    def _run_inner(self, resume: bool = True) -> Solution:
        rt = self.config.runtime
        nt = self.d_obs.shape[1]
        start_t, state = 0, None
        if resume:
            step, state, cfg_json = ckpt_mod.resume(rt.checkpoint_dir)
            if state is not None and not resumable(self.config, cfg_json):
                self.metrics.write(dict(
                    event="checkpoint_config_mismatch", action="ignored",
                    checkpoint_dir=rt.checkpoint_dir, step=step))
                step, state = 0, None
            if state is not None:
                state = pipeline_checkpoint_from_numpy(state)
            start_t = step
        m_list = list(state["m_seq"][:start_t]) if state is not None else []

        solver_name = self.config.solver.solver
        if solver_name == "kalman":
            return self._run_kalman(start_t=start_t, state=state)
        if solver_name == "enkf":
            return self._run_enkf(start_t=start_t, state=state)
        if solver_name == "batched_gn":
            if start_t >= nt:
                return Solution(self.grid, np.stack(m_list),
                                config_json=self.config.to_json())
            return self._run_batched()

        # warm start from the last checkpointed state, exactly as the
        # uninterrupted run chains timesteps
        sc = self.config.solver
        m_prev = (as_tensor(m_list[-1], device=self.device) if m_list
                  else None)
        std_list = (list(state["m_std"][:start_t])
                    if state is not None and "m_std" in state else [])
        for t in range(start_t, nt):
            m_t, diag = self.solve_snapshot(t, m0=m_prev)
            m_list.append(host(m_t))
            m_prev = m_t
            if sc.posterior_samples > 0:
                std = self.posterior_std(t, sc.posterior_samples,
                                         m_field=m_t)
                std_list.append(host(std))
                diag["posterior_std_mean"] = float(torch.mean(std))
            self.metrics.write(diag)
            if (t + 1) % rt.checkpoint_every == 0 or t == nt - 1:
                state_out = {"m_seq": np.stack(m_list)}
                if std_list:
                    state_out["m_std"] = np.stack(std_list)
                ckpt_mod.save_checkpoint(rt.checkpoint_dir, t + 1,
                                         state_out, self.config.to_json())
        diags = dict(std_seq=np.stack(std_list)) if std_list else None
        return Solution(self.grid, np.stack(m_list), diagnostics=diags,
                        config_json=self.config.to_json())

    def _filter_start(self, state, nt):
        """What both filters resume or estimate before their chunks: (the
        cadence in seconds, the wind state, the noise scale)."""
        dt_s = (float(np.diff(self.datapack.times).mean() * 86400.0)
                if nt > 1 else 0.0)
        if state is not None and "wind_kmps" in state:
            wind = np.asarray(state["wind_kmps"])
        else:
            wind = self._estimate_wind(nt, dt_s)
        wind = self._maybe_shear_state(wind)
        noise_scale = (float(state["noise_scale"])
                       if state is not None and "noise_scale" in state
                       else 1.0)
        return dt_s, wind, noise_scale

    def _chunk_events(self, c0, chunk, m_lin, noise_scale):
        """The chunk-boundary events of both filters: online R adaptation
        (skipped at the cold c0 = 0 boundary, where the innovation is all
        signal; the absolute chunk index keeps resumed and uninterrupted
        runs adapting at the same epochs) and the spectrum diagnostic.
        Returns the new noise scale."""
        sc = self.config.solver
        if (sc.noise_adapt_every > 0 and c0 > 0
                and (c0 // chunk) % sc.noise_adapt_every == 0):
            rho = self._fit_noise_scale(c0, m_lin, noise_scale)
            noise_scale *= rho
            self.metrics.write(dict(event="noise_adapted", t=c0, rho=rho,
                                    noise_scale=noise_scale))
        if (sc.diag_spectrum_every > 0
                and (c0 // chunk) % sc.diag_spectrum_every == 0):
            self._diag_spectrum(c0, m_lin, noise_scale)
        return noise_scale

    def _filter_kw(self, c0, c1):
        """The keyword arguments both filters take from the config."""
        sc, rc = self.config.solver, self.config.rays
        return dict(
            num_directions=self.directions.shape[1], i0=self.i0,
            cg_iters=sc.cg_iters, cg_tol=sc.cg_tol, fade=sc.kalman_fade,
            advect_first=(c0 > 0), m_clim=self.m_prior,
            anchors=self.anchors,
            anchor_cov=(self.anchor_cov if self.anchors is not None
                        else None),
            quadrature=rc.quadrature, interp=rc.interp,
            interp_inner=rc.interp_inner or None,
            m_clim_seq=self._clim_seq(c0, c1),
            wind_adapt_iters=sc.wind_adapt_iters)

    def _run_enkf(self, start_t: int = 0, state=None) -> Solution:
        """Ensemble Kalman mode: time-propagated posterior uncertainty
        (mean + spread per timestep). Chunked and resumable like the point
        filter: the full ensemble is checkpointed and every draw is keyed
        by the global timestep, so chunked, resumed and single-chunk runs
        are identical."""
        sc, rt = self.config.solver, self.config.runtime
        member_mode = self.mesh is not None and sc.enkf_shard == "members"
        if member_mode:
            # member parallelism: each device owns enkf_members / S members
            # end to end (kalman.member_parallel_enkf); the rays stay
            # whole, the ensemble axis shards
            m_mesh = shard_mod.member_mesh(self.mesh.devices)
            if sc.enkf_members % m_mesh.size:
                raise ValueError(
                    f"enkf_shard='members' needs enkf_members "
                    f"({sc.enkf_members}) divisible by the device count "
                    f"({m_mesh.size})")
        nt = self.d_obs.shape[1]
        chunk = max(1, sc.kalman_chunk)
        dt_s, wind, noise_scale = self._filter_start(state, nt)
        b = sc.enkf_members
        mean_list = (list(state["m_seq"][:start_t])
                     if state is not None else [])
        std_list = (list(state["enkf_std"][:start_t])
                    if state is not None and "enkf_std" in state else [])
        pre = (list(state["kalman_pre"][:start_t])
               if state is not None and "kalman_pre" in state else [])
        ens = (as_tensor(state["enkf_ensemble"], device=self.device)
               if state is not None and start_t > 0
               and "enkf_ensemble" in state else None)
        if member_mode:
            if ens is None:
                ens = initial_ensemble(
                    self.grid, self.cov, self.m_prior, self.draw_normals(
                        DRAW_ENKF_INIT, 0, (b,) + tuple(self.grid.shape)))
            ens = shard_mod.member_sharding(m_mesh)(ens)
        n_rows = (self._padded_na(self.d_obs.shape[0])
                  * self.directions.shape[1])
        t0 = time.perf_counter()
        for c0 in range(start_t, nt, chunk):
            c1 = min(c0 + chunk, nt)
            m_lin = (as_tensor(mean_list[-1], device=self.device)
                     if mean_list else self.m_prior)
            noise_scale = self._chunk_events(c0, chunk, m_lin, noise_scale)
            rays_seq, inner_seq, d_chunk, noise_chunk = \
                self._chunk_arrays(c0, c1, shard=not member_mode)
            steps = range(c0, c1)
            draws = dict(obs_noise=torch.stack([
                self.draw_normals(DRAW_ENKF_OBS, t, (b, n_rows))
                for t in steps]))
            if ens is None:
                draws["init_noise"] = self.draw_normals(
                    DRAW_ENKF_INIT, 0, (b,) + tuple(self.grid.shape))
            if sc.enkf_process_sigma:
                draws["process_noise"] = torch.stack([
                    self.draw_normals(DRAW_ENKF_PROCESS, t,
                                      (b,) + tuple(self.grid.shape))
                    for t in steps])
            if self.anchors is not None \
                    and sc.enkf_anchor_update == "stochastic":
                draws["anchor_noise"] = torch.stack([
                    self.draw_normals(DRAW_ENKF_ANCHOR, t,
                                      (b, self.anchors.values.shape[-1]))
                    for t in steps])
            # the chunk's draws are indexed from its first step
            filter_fn = (
                (lambda *a, **kw: member_parallel_enkf(m_mesh, *a, **kw))
                if member_mode else ensemble_kalman_filter)
            res = filter_fn(
                self.grid, rays_seq, d_chunk, noise_chunk * noise_scale,
                self.m_prior, self.cov, wind, dt_s, n_members=b,
                process_sigma=sc.enkf_process_sigma,
                inflation=sc.enkf_inflation,
                spectrum_blend=sc.enkf_spectrum_blend, ens0=ens,
                step_offset=0, anchor_update=sc.enkf_anchor_update,
                rays_inner_seq=inner_seq, **draws,
                **self._filter_kw(c0, c1))
            mean_list.extend(host(res.mean_seq))
            std_list.extend(host(res.std_seq))
            pre.extend(host(res.residuals))
            ens = res.ensemble
            if sc.wind_adapt_iters > 0:
                wind = host(res.wind_seq[-1]).astype(np.float64)
            ckpt_mod.save_checkpoint(
                rt.checkpoint_dir, c1,
                {"m_seq": np.stack(mean_list),
                 "enkf_std": np.stack(std_list),
                 "kalman_pre": np.asarray(pre),
                 "enkf_ensemble": host(ens.gather() if member_mode
                                       else ens), "wind_kmps": wind,
                 "noise_scale": noise_scale},
                self.config.to_json())
            self.metrics.write(dict(solver="enkf", event="chunk",
                                    t_from=c0, t_to=c1,
                                    seconds=time.perf_counter() - t0))
        dt = time.perf_counter() - t0
        self.metrics.write(dict(solver="enkf", seconds=dt, timesteps=nt,
                                members=b,
                                steps_per_sec=(nt - start_t) / max(dt, 1e-9)))
        return Solution(self.grid, np.stack(mean_list),
                        diagnostics=dict(std_seq=np.stack(std_list),
                                         pre_residuals=np.asarray(pre)),
                        config_json=self.config.to_json())

    def _run_batched(self) -> Solution:
        """Independent snapshots from the prior, no warm chaining (SURVEY
        §2.1 P2; ``solvers.map_gauss_newton_batched``). All-or-nothing:
        one checkpoint at the end, as in the reference."""
        sc, rt = self.config.solver, self.config.runtime
        nd = self.directions.shape[1]
        nt = self.d_obs.shape[1]
        per_t = [self._padded_data(t) for t in range(nt)]
        bundles = [self.rays_for_time(t, antennas=per_t[t][0])
                   for t in range(nt)]
        rays_seq = rays_mod.RayBundle(
            points=torch.stack([b.points for b in bundles]),
            ds=torch.stack([b.ds for b in bundles]))
        d_seq = torch.stack([p[1] for p in per_t])
        noise_seq = torch.stack([p[2] for p in per_t])
        self._sync()
        t0 = time.perf_counter()
        res = solvers.map_gauss_newton_batched(
            self.grid, rays_seq, d_seq, noise_seq, self.m_prior, self.cov,
            num_directions=nd, i0=self.i0, gn_iters=sc.gn_iters,
            cg_iters=sc.cg_iters, cg_tol=sc.cg_tol,
            quadrature=self.config.rays.quadrature,
            interp=self.config.rays.interp,
            rays_inner_seq=self._inner(rays_seq),
            warm_start=sc.warm_start,
            interp_inner=self.config.rays.interp_inner or None)
        m = host(res.m)
        dt = time.perf_counter() - t0
        self.metrics.write(dict(solver="batched_gn", seconds=dt,
                                timesteps=nt, timesteps_per_sec=nt / dt))
        ckpt_mod.save_checkpoint(rt.checkpoint_dir, nt, {"m_seq": m},
                                 self.config.to_json())
        return Solution(self.grid, m,
                        diagnostics=dict(residuals=host(res.residual_norm)),
                        config_json=self.config.to_json())

    def _maybe_shear_state(self, wind):
        """``solver.wind_shear``: promote a (3,) bulk wind to the (2, 3)
        rigid + vertical-shear advection state (zero shear start). Resumed
        (2, 3) states pass through unchanged."""
        if self.config.solver.wind_shear and np.ndim(wind) == 1:
            return np.stack([np.asarray(wind, np.float64), np.zeros(3)])
        return wind

    def _estimate_wind(self, nt: int, dt_s: float):
        """Bulk wind: datapack metadata when present (synthetic worlds),
        otherwise estimated from single-snapshot solves of the first two
        timesteps through the frozen-flow match."""
        wind = getattr(self.datapack, "wind_kmps", None)
        if wind is not None:
            return np.asarray(wind, np.float64)
        if nt >= 2 and dt_s > 0:
            from ..models.frozen_flow import estimate_wind
            m0_est, _ = self.solve_snapshot(0)
            m1_est, _ = self.solve_snapshot(1)
            v, _ = estimate_wind(m0_est - self.m_prior,
                                 m1_est - self.m_prior,
                                 self.grid, dt_s, n_iters=200)
            wind = host(v).astype(np.float64)
            self.metrics.write(dict(event="wind_estimated",
                                    wind_kmps=list(map(float, wind))))
            return wind
        return np.zeros(3)

    def _run_kalman(self, start_t: int = 0, state=None) -> Solution:
        """Config-5 filter, chunked for fault tolerance: ceil(Nt /
        kalman_chunk) calls, checkpointing the filtered sequence (+ wind)
        after each. ``advect_first``/``m_clim`` make the chunked filter
        bit-identical to a single call, and resume continues mid-sequence
        from the newest checkpoint."""
        sc, rt = self.config.solver, self.config.runtime
        nt = self.d_obs.shape[1]
        chunk = max(1, sc.kalman_chunk)
        dt_s, wind, noise_scale = self._filter_start(state, nt)
        m_list = list(state["m_seq"][:start_t]) if state is not None else []
        pre = (list(state["kalman_pre"][:start_t])
               if state is not None and "kalman_pre" in state else [])
        post = (list(state["kalman_post"][:start_t])
                if state is not None and "kalman_post" in state else [])
        m_cur = (as_tensor(m_list[-1], device=self.device) if m_list
                 else self.m_prior)
        t0 = time.perf_counter()
        for c0 in range(start_t, nt, chunk):
            c1 = min(c0 + chunk, nt)
            noise_scale = self._chunk_events(c0, chunk, m_cur, noise_scale)
            rays_seq, inner_seq, d_chunk, noise_chunk = \
                self._chunk_arrays(c0, c1)
            res = kalman_filter(
                self.grid, rays_seq, d_chunk, noise_chunk * noise_scale,
                m_cur, self.cov, wind, dt_s, rays_inner_seq=inner_seq,
                **self._filter_kw(c0, c1))
            m_list.extend(host(res.m_seq))
            pre.extend(host(res.residuals))
            post.extend(host(res.post_residuals))
            m_cur = res.m_seq[-1]
            if sc.wind_adapt_iters > 0:
                # carry the refined wind into the next chunk and the
                # checkpoint, so resume continues the adapted estimate
                wind = host(res.wind_seq[-1]).astype(np.float64)
            ckpt_mod.save_checkpoint(
                rt.checkpoint_dir, c1,
                {"m_seq": np.stack(m_list), "kalman_pre": np.asarray(pre),
                 "kalman_post": np.asarray(post), "wind_kmps": wind,
                 "noise_scale": noise_scale},
                self.config.to_json())
            self.metrics.write(dict(solver="kalman", event="chunk",
                                    t_from=c0, t_to=c1,
                                    seconds=time.perf_counter() - t0))
        dt = time.perf_counter() - t0
        self.metrics.write(dict(solver="kalman", seconds=dt, timesteps=nt,
                                steps_per_sec=(nt - start_t) / max(dt, 1e-9)))
        return Solution(self.grid, np.stack(m_list),
                        diagnostics=dict(pre_residuals=np.asarray(pre),
                                         post_residuals=np.asarray(post)),
                        config_json=self.config.to_json())
