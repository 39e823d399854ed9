"""Streaming epoch service, the deployable serving surface (port of
``ionotomo_tpu.serving``).

A live calibration system produces observation epochs continuously; this
service watches a directory for DataPack files, pushes each epoch through
the online frozen-flow filter (``inversion.online``), and writes a
Solution (+ JSONL diagnostics) per epoch with a restartable state file.

    svc = EpochService(watch_dir, out_dir, config)   # device: the card
    svc.run(poll_s=2.0)            # or svc.process_available() per tick

Contract (the reference's):
- Epoch files are DataPack HDF5 (one or more timesteps each), processed in
  sorted filename order, exactly once (processed names persist in the
  state file). Unreadable (partially-written) files pause ingestion until
  the next poll so epochs are never assimilated out of time order.
- The frozen-flow advection step is the actual time since the last
  assimilated epoch (tracked across files and restarts); out-of-order
  epochs assimilate without advection.
- The model grid and prior are fixed at service start from the **first**
  file's geometry plus the configured padding; rays are rebuilt per
  timestep.
- Restart: a new EpochService over the same ``out_dir`` resumes from
  ``state.npz`` and produces bit-identical output to an uninterrupted
  service. The state file has the reference's keys and config guard, so
  either package resumes the other's state.
- Ionosonde soundings: files named ``*.sounding.npz`` (``points_enu``
  (P,3) ENU km, ``ne_m3`` (P,), ``noise_frac``) are assimilated as point
  log-density rows when they arrive, held until the first epoch has
  landed, folded into the climatology pull target by default
  (``probe_update_clim``); invalid ones are recorded in the JSONL and
  skipped.

Randomness (the ensemble's draws, the adaptive-R probes, the beam noise,
the spectrum diagnostic's start block) comes from a CPU
``torch.Generator`` seeded from (``seed``, a constant for each use, the
persisted global epoch index) by ``utils.draws``, and the draws move to
the service's device afterwards: a restarted service draws the same numbers without storing
any generator state, and a service on the card draws what one on the CPU
does. The reference keys the same uses by its PRNG keys, so the two
packages agree on the services that draw nothing (the point filter
without ``adapt_r`` or beam noise).

Files go through two methods, ``read_epoch`` (a DataPack from a path) and
``write_solution`` (a Solution to a path), which a subclass may replace.

CLI: ``python -m ionotomo_tpu_torch serve IN_DIR OUT_DIR [--solver enkf]``.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .config import EngineConfig, resumable
from .core.grids import Grid3D
from .data.datapack import DataPack
from .device import as_tensor, host, resolve
from .geometry import rays as rays_mod
from .inversion.online import OnlineEnsembleKalman, OnlineKalman
from .inversion.priors import GPCovariance
from .inversion.solution import Solution
from .models import chapman
from .utils import checkpoint as ckpt_mod
from .utils.draws import (DRAW_ENKF_ANCHOR, DRAW_ENKF_INIT, DRAW_ENKF_OBS,
                          DRAW_ENKF_PROCESS, DRAW_SPECTRUM, normals)

#: The constants that key the service's own draws (with the seed and the
#: global epoch index; ``utils.draws`` keys the uses it shares with the
#: batch pipeline).
DRAW_ADAPT_R = 0xADA0       # adaptive-R probes (the reference's key)
DRAW_BEAM = 0xBEA11         # beam-noise jitter (the reference's key)

#: Adaptive-R probes per epoch (the reference's ``stats_probes``).
STATS_PROBES = 2


class EpochService:
    """Watch ``watch_dir`` for DataPack epochs, filter, emit Solutions."""

    def __init__(self, watch_dir, out_dir, config: EngineConfig = None,
                 wind_kmps=(0.0, 0.0, 0.0), anchors=None, anchor_cov=None,
                 vtec_anchors_npz=None, seed: int = 0, probe_cov=None,
                 probe_update_clim: bool = True, device=None):
        """``vtec_anchors_npz``: path to an npz of external VTEC
        constraints (``points_xy`` (A,2) ENU km, ``values_tecu`` (A,),
        ``noise_tecu`` scalar); the anchors are built at bootstrap, once
        the grid exists. Alternatively pass a ready ``TecAnchors`` via
        ``anchors`` (+ optional ``anchor_cov``; defaults to a
        long-horizontal background covariance).

        ``seed``: the service's random draws (module docstring).
        ``probe_cov``: background covariance for sounding assimilation
        (None: ~80 km vertical, ``anchors.assimilate_probes``).
        ``probe_update_clim``: fold each sounding's correction into the
        climatology pull target so it persists under fade. ``device``:
        where the state lives and the filter runs (the card unless
        named)."""
        self.device = resolve(device)
        self.watch_dir = str(watch_dir)
        self.out_dir = str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.config = config or EngineConfig()
        self.state_path = os.path.join(self.out_dir, "state.npz")
        self.metrics_path = os.path.join(self.out_dir, "epochs.jsonl")
        self.processed: list[str] = []
        self.filter = None
        self.last_mjd = None           # cadence tracking (advection dt)
        self._wind = np.asarray(wind_kmps, np.float64)
        if self.config.solver.wind_shear and self._wind.ndim == 1:
            # (2,3) rigid + vertical-shear advection state, zero shear
            # start, learned online when wind_adapt_iters > 0
            self._wind = np.stack([self._wind, np.zeros(3)])
        self._anchors = anchors
        self._anchor_cov = anchor_cov
        self._anchors_npz = vtec_anchors_npz
        self._probe_cov = probe_cov
        self._probe_update_clim = bool(probe_update_clim)
        self._clim_delta = None    # accumulated sounding corrections
        self._sounding_fail = {}   # name -> size at last schema failure
        self.seed = int(seed)
        if os.path.exists(self.state_path):
            self._load_state()

    # --- files -----------------------------------------------------------

    def read_epoch(self, path) -> DataPack:
        """The DataPack in an epoch file; raises OSError or KeyError for a
        file that cannot be read (yet)."""
        return DataPack.load(path)

    def write_solution(self, sol: Solution, path):
        """Write one epoch's Solution."""
        sol.save(path)

    def _log(self, **record):
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _normals(self, use: int, index: int, shape) -> torch.Tensor:
        return normals(self.seed, use, index, shape).to(self.device)

    # --- state -----------------------------------------------------------

    def _save_state(self):
        state = dict(self.filter.state_dict())
        state["processed"] = np.asarray(self.processed, dtype="U")
        state["grid_origin"] = host(self.grid.origin)
        state["grid_spacing"] = host(self.grid.spacing)
        state["grid_shape"] = np.asarray(self.grid.shape)
        state["last_mjd"] = np.float64(
            self.last_mjd if self.last_mjd is not None else np.nan)
        # anchors are part of the run's identity (like the config): a
        # restart with different/missing anchors must refuse
        if self._anchors is not None:
            state["anchor_points"] = host(self._anchors.rays.points)
            state["anchor_values"] = host(self._anchors.values)
            state["anchor_noise"] = host(self._anchors.noise_std)
        if self._clim_delta is not None:
            # the accumulated sounding corrections and the shifted pull
            # target itself, restored verbatim so restarts reproduce the
            # uninterrupted float sequence bit-exactly
            state["probe_clim_delta"] = host(self._clim_delta)
            state["probe_m_clim"] = host(self.filter.m_clim)
        # the probe settings are part of the run's identity too
        state["probe_fingerprint"] = np.asarray(self._probe_fingerprint(),
                                                dtype="U")
        ckpt_mod.save_checkpoint(self.out_dir, self.filter.t, state,
                                 self.config.to_json(),
                                 name=os.path.basename(self.state_path))

    def _load_state(self):
        with np.load(self.state_path, allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        self.processed = [str(s) for s in state.pop("processed")]
        self.grid = Grid3D.create(state.pop("grid_origin"),
                                  state.pop("grid_spacing"),
                                  tuple(int(s)
                                        for s in state.pop("grid_shape")),
                                  device=self.device)
        lm = float(state.pop("last_mjd", np.nan))
        self.last_mjd = None if np.isnan(lm) else lm
        cfg_json = bytes(state.pop("__config__", np.zeros(0, np.uint8))
                         ).rstrip(b"\x00").decode()
        if not resumable(self.config, cfg_json):
            raise ValueError(
                "state.npz in the output directory was produced under a "
                "different engine configuration — resuming would silently "
                "mix two runs; point the service at a fresh out_dir or "
                "restore the original configuration")
        saved_probe_fp = str(state.pop("probe_fingerprint", ""))
        if saved_probe_fp and saved_probe_fp != self._probe_fingerprint():
            raise ValueError(
                "state.npz was produced with different ionosonde-probe "
                "settings (probe_cov / probe_update_clim) than this "
                "service is configured with — resuming would silently "
                "change the stream's response to future soundings; use a "
                "fresh out_dir or restore the original probe settings")
        self._build_filter()
        if "probe_clim_delta" in state:
            self._clim_delta = self._field(state.pop("probe_clim_delta"))
            self.filter.m_clim = self._field(state.pop("probe_m_clim"))
        saved_anchor = {k: state.pop(k) for k in
                        ("anchor_points", "anchor_values", "anchor_noise")
                        if k in state}
        mine = self._anchors
        if bool(saved_anchor) != (mine is not None) or (
                saved_anchor and not (
                    np.allclose(saved_anchor["anchor_points"],
                                host(mine.rays.points))
                    and np.allclose(saved_anchor["anchor_values"],
                                    host(mine.values))
                    and np.allclose(saved_anchor["anchor_noise"],
                                    host(mine.noise_std)))):
            raise ValueError(
                "state.npz was produced with different absolute-TEC "
                "anchors than this service is configured with — resuming "
                "would silently change the stream's absolute level; use "
                "a fresh out_dir or restore the original anchors")
        self.filter.load_state(state)
        # drop diagnostics of epochs that will be re-emitted (a crash
        # mid-file re-processes that file); event records without an
        # "epoch" key are the audit trail of skipped files and stay
        if os.path.exists(self.metrics_path):
            kept = []
            with open(self.metrics_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if "epoch" not in rec or rec["epoch"] < self.filter.t:
                        kept.append(line)
            with open(self.metrics_path, "w") as f:
                f.writelines(kept)

    def _field(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def _probe_fingerprint(self) -> str:
        """Canonical JSON of the sounding-assimilation settings: the
        restart-identity record for ``probe_cov``/``probe_update_clim``. A
        custom covariance is fingerprinted by its defining parameters
        (GPCovariance carries them); an object without them by its type
        name."""
        cov = self._probe_cov
        if cov is None:
            cov_fp = None
        else:
            try:
                ls = cov.length_scale
                ls = (list(np.asarray(ls, np.float64).ravel())
                      if np.ndim(ls) else float(ls))
                cov_fp = dict(sigma=float(cov.sigma), length_scale=ls,
                              kind=str(cov.kind))
            except AttributeError:
                cov_fp = dict(type=type(cov).__name__)
        return json.dumps(dict(update_clim=self._probe_update_clim,
                               cov=cov_fp), sort_keys=True)

    # --- setup -----------------------------------------------------------

    def _bootstrap(self, dp: DataPack):
        """Fix grid/prior/filter from the first epoch's geometry."""
        c = self.config
        self.grid = chapman.grid_enclosing_rays(
            dp.antennas_enu(), dp.directions_enu().reshape(-1, 3),
            max_length_km=c.physics.max_length_km, shape=c.grid.shape,
            pad_km=c.grid.pad_km, h_min_km=c.grid.h_min_km,
            device=self.device)
        self._build_filter()

    def _build_filter(self):
        from .inversion import anchors as anchors_mod

        c = self.config
        if self._anchors_npz and self._anchors is None:
            self._anchors = anchors_mod.anchors_from_npz(
                self.grid, self._anchors_npz)
        if self._anchors is not None and self._anchor_cov is None:
            self._anchor_cov = anchors_mod.background_covariance(self.grid)
        ne0 = chapman.chapman_field(self.grid,
                                    n_peak=c.physics.chapman_n_peak,
                                    h_peak_km=c.physics.chapman_h_peak_km,
                                    scale_km=c.physics.chapman_scale_km,
                                    curved=c.physics.curved_earth)
        m_prior = chapman.log_parametrize(ne0)
        cov = GPCovariance.create(self.grid, sigma=c.prior.sigma,
                                  length_scale=c.prior.length_scale_km,
                                  kind=c.prior.kind)
        kw = dict(cg_iters=c.solver.cg_iters, cg_tol=c.solver.cg_tol,
                  fade=c.solver.kalman_fade, anchors=self._anchors,
                  anchor_cov=self._anchor_cov,
                  quadrature=c.rays.quadrature,
                  interp=c.rays.interp,
                  interp_inner=c.rays.interp_inner or None,
                  inner_samples=c.rays.inner_samples,
                  adapt_r=c.solver.adapt_r,
                  wind_adapt_iters=c.solver.wind_adapt_iters)
        if c.solver.solver == "enkf":
            self.filter = OnlineEnsembleKalman(
                self.grid, cov, m_prior, self._wind, dt_s=30.0,
                num_directions=1, n_members=c.solver.enkf_members,
                process_sigma=c.solver.enkf_process_sigma,
                inflation=c.solver.enkf_inflation,
                spectrum_blend=c.solver.enkf_spectrum_blend,
                anchor_update=c.solver.enkf_anchor_update, **kw)
        else:
            self.filter = OnlineKalman(
                self.grid, cov, m_prior, self._wind, dt_s=30.0,
                num_directions=1, **kw)

    def _epoch_clim(self, dp: DataPack, t: int):
        """Climatological log-density field at epoch t's solar zenith: the
        per-epoch fade-pull target for ``physics.time_varying_clim``
        (scalar cos χ over the flat serving grid)."""
        from .geometry import frames
        c = self.config.physics
        cc = float(frames.solar_cos_zenith(float(dp.times[t]),
                                           dp.array.enu_frame))
        ne = chapman.chapman_field(self.grid, n_peak=c.chapman_n_peak,
                                   h_peak_km=c.chapman_h_peak_km,
                                   scale_km=c.chapman_scale_km,
                                   cos_chi=cc, curved=c.curved_earth)
        return chapman.log_parametrize(ne)

    def _beam_inflation(self, dp: DataPack, dev, t: int):
        """Per-epoch strong-turbulence noise inflation (rays.beam_noise >
        0): the chaotic dTEC spread of a stochastic Fresnel beam traced
        through the filter's current field estimate
        (``geometry.fermat.beam_noise_for_epoch``). The jitter is drawn
        from the persisted global epoch index, and the field estimate is
        restored exactly on restart, so resumed streams inflate
        bit-identically. Returns an (Na, Nd) tensor in working units;
        logs the spread."""
        from .geometry import fermat

        rc, p = self.config.rays, self.config.physics
        f = self.filter
        if hasattr(f, "m"):
            m_field = f.m                       # point filter state
        elif f.ens is not None:
            m_field = f.ens.mean(0)             # EnKF mean
        else:
            m_field = f.m_clim                  # first epoch: bootstrap
        n_rays = dev["antennas_enu"].shape[0] * dev["directions_enu"].shape[1]
        noise = self._normals(DRAW_BEAM, f.t, (rc.beam_noise - 1, n_rays, 2))
        infl = fermat.beam_noise_for_epoch(
            m_field, self.grid, dev["antennas_enu"],
            dev["directions_enu"][t], dp.frequency_hz, noise,
            n_paths=rc.beam_noise, i0=f.i0,
            jitter_rad=(rc.beam_jitter_rad or None),
            max_length_km=p.max_length_km, n_steps=rc.n_steps,
            method=rc.method, interp=rc.interp)
        # keyed "epoch" (not "t") so the restart prune drops records of
        # epochs that will be re-emitted
        self._log(event="beam_noise", epoch=f.t, n_paths=rc.beam_noise,
                  mean=round(float(torch.mean(infl)), 4),
                  max=round(float(torch.max(infl)), 4))
        return infl

    def _step(self, rb, d_t, noise_t, m_clim_t):
        """One filter step with this epoch's draws."""
        f = self.filter
        if isinstance(f, OnlineEnsembleKalman):
            b = f.n_members
            kw = dict(obs_noise=self._normals(DRAW_ENKF_OBS, f.t,
                                              (b, d_t.numel())))
            if f.ens is None:
                kw["init_noise"] = self._normals(DRAW_ENKF_INIT, 0,
                                                 (b,) + self.grid.shape)
            if f.process_sigma:
                kw["process_noise"] = self._normals(
                    DRAW_ENKF_PROCESS, f.t, (b,) + self.grid.shape)
            if f.anchors is not None and f.anchor_update == "stochastic":
                kw["anchor_noise"] = self._normals(
                    DRAW_ENKF_ANCHOR, f.t,
                    (b, f.anchors.values.shape[-1]))
            return f.step(rb, d_t, noise_t, m_clim=m_clim_t, **kw)
        stats = (self._normals(DRAW_ADAPT_R, f.t,
                               (STATS_PROBES,) + self.grid.shape)
                 if f.adapt_r > 0.0 else None)
        return f.step(rb, d_t, noise_t, m_clim=m_clim_t, stats_noise=stats)

    # --- ingest ----------------------------------------------------------

    def _pending(self):
        return sorted(f for f in os.listdir(self.watch_dir)
                      if f.endswith((".h5", ".hdf5", ".sounding.npz"))
                      and f not in self.processed)

    def _ingest_sounding(self, name: str, path: str):
        """Assimilate one ``*.sounding.npz`` ionosonde file. Held (left
        pending) until an epoch has landed; permanently invalid files are
        recorded and marked processed. A file failing schema validation
        is retried until its size is stable across two polls (a truncated
        npz member raises what a malformed file does).

        Returns True when an ingest was attempted, False when the file was
        held."""
        import zipfile

        from .data.ionosonde import probes_from_arrays

        if self.filter is None or self.filter.t == 0:
            return False                 # retry once an epoch has landed

        def _unreadable(e):
            self._log(event="unreadable", file=name, error=str(e)[:200])

        def _bad(e):
            self._sounding_fail.pop(name, None)
            self._log(event="bad_sounding", file=name, error=str(e)[:200])
            self.processed.append(name)
            self._save_state()

        # stage 1: read the raw arrays (I/O-shaped errors: retry)
        try:
            with np.load(path, allow_pickle=False) as z:
                raw = dict(points_enu=np.array(z["points_enu"]),
                           ne_m3=np.array(z["ne_m3"]),
                           noise_frac=np.array(z["noise_frac"]))
        except (OSError, zipfile.BadZipFile) as e:
            _unreadable(e)
            return True
        except (ValueError, KeyError) as e:
            try:
                size = os.path.getsize(path)
            except OSError:
                return True              # vanished mid-read: retry
            if self._sounding_fail.get(name) != size:
                self._sounding_fail[name] = size
                _unreadable(e)
                return True              # retry once the size is stable
            _bad(e)
            return True
        # stage 2: semantic validation; the file read cleanly, so this is
        # permanently invalid
        try:
            probes = probes_from_arrays(self.grid, raw["points_enu"],
                                        raw["ne_m3"], raw["noise_frac"])
        except (ValueError, KeyError) as e:
            _bad(e)
            return True
        self._sounding_fail.pop(name, None)
        t0 = time.perf_counter()
        delta = self.filter.assimilate_probes(probes, cov=self._probe_cov)
        if self._probe_update_clim:
            self.filter.m_clim = self.filter.m_clim + delta
            self._clim_delta = (delta if self._clim_delta is None
                                else self._clim_delta + delta)
        self._log(event="sounding", file=name,
                  n_probes=int(probes.values.shape[0]),
                  seconds=round(time.perf_counter() - t0, 3),
                  mean_abs_dlogne=round(float(torch.mean(torch.abs(delta))),
                                        6))
        self.processed.append(name)
        self._save_state()
        return True

    def process_available(self) -> int:
        """Ingest every unprocessed epoch file currently present; returns
        the number of epochs (timesteps) assimilated."""
        n_epochs = 0
        tried_soundings = set()
        for name in self._pending():
            path = os.path.join(self.watch_dir, name)
            if name.endswith(".sounding.npz"):
                if self._ingest_sounding(name, path):
                    tried_soundings.add(name)
                continue
            try:
                dp = self.read_epoch(path)
            except (OSError, KeyError) as e:
                # partially-written / unreadable: leave it unprocessed,
                # note it, retry on the next poll; stop here so later
                # files are not assimilated out of time order
                self._log(event="unreadable", file=name, error=str(e)[:200])
                break
            if self.filter is None:
                self._bootstrap(dp)
            na, nt, nd = dp.shape
            dev = dp.to_device_arrays()
            noise = np.where(dev["flags"], np.float32(1e6), dev["noise_std"])
            self.filter.nd = nd
            ants = as_tensor(dev["antennas_enu"], device=self.device)
            for t in range(nt):
                # time-varying climatology: the fade-pull target follows
                # the epoch's solar zenith; it depends only on the file
                # and the config, so restarts stay bit-identical
                m_clim_t = (self._epoch_clim(dp, t)
                            if self.config.physics.time_varying_clim
                            else None)
                if m_clim_t is not None and self._clim_delta is not None:
                    # the sounding-learned correction on top of the
                    # terminator-tracking background
                    m_clim_t = m_clim_t + self._clim_delta
                # advection step = actual time since the last assimilated
                # epoch; an out-of-order epoch gets dt_s = 0 (no
                # advection); dt_s persists in the state file
                if self.last_mjd is not None:
                    dt = (float(dp.times[t]) - self.last_mjd) * 86400.0
                    self.filter.dt_s = max(dt, 0.0)
                self.last_mjd = float(dp.times[t])
                origins, dvecs = rays_mod.make_ray_batch(
                    ants, as_tensor(dev["directions_enu"][t],
                                    device=self.device))
                rb = rays_mod.sample_straight_rays(
                    origins, dvecs,
                    max_length_km=self.config.physics.max_length_km,
                    n_samples=self.config.rays.n_samples)
                noise_t = as_tensor(noise[:, t, :], device=self.device)
                if self.config.rays.beam_noise > 0:
                    infl = self._beam_inflation(dp, dev, t)
                    noise_t = torch.sqrt(noise_t * noise_t + infl * infl)
                d_t = as_tensor(dev["dtec"][:, t, :], device=self.device)
                t0 = time.perf_counter()
                out = self._step(rb, d_t, noise_t, m_clim_t)
                secs = time.perf_counter() - t0
                epoch = self.filter.t - 1
                if len(out) == 3:          # ensemble: (mean, std, diag)
                    m_t, std_t, diag = out
                    sol = Solution(self.grid, m_t[None],
                                   diagnostics=dict(std=std_t[None]),
                                   config_json=self.config.to_json())
                else:
                    m_t, diag = out
                    sol = Solution(self.grid, m_t[None],
                                   config_json=self.config.to_json())
                self.write_solution(sol, os.path.join(
                    self.out_dir, f"epoch_{epoch:06d}.h5"))
                self._log(epoch=epoch, file=name, seconds=round(secs, 3),
                          **diag)
                every = self.config.solver.diag_spectrum_every
                if every > 0 and epoch % every == 0:
                    self._spectrum(epoch, rb, noise_t, m_t, nd)
                n_epochs += 1
            self.processed.append(name)
            self._save_state()
        # soundings held while the filter did not exist sort before the
        # first epoch file and were skipped above; revisit them now that
        # epochs have landed
        if self.filter is not None and self.filter.t > 0:
            for name in self._pending():
                if (name.endswith(".sounding.npz")
                        and name not in tried_soundings):
                    self._ingest_sounding(
                        name, os.path.join(self.watch_dir, name))
        return n_epochs

    def _spectrum(self, epoch, rb, noise_t, m_t, nd):
        """The update operator's top-rank spectrum of
        I + C^½JᵀC_d⁻¹JC^½ at the freshly assimilated state, logged keyed
        by "epoch" so the restart prune treats it like an epoch record."""
        from .inversion.kalman import update_operator_eigs

        rank = min(self.config.solver.diag_spectrum_rank,
                   self.grid.num_voxels)
        z = self._normals(DRAW_SPECTRUM, epoch,
                          (self.grid.num_voxels, rank + 8))
        _, lam = update_operator_eigs(
            self.grid, rb, noise_t, m_t, self.filter.cov, nd, z, rank=rank,
            i0=self.filter.i0, quadrature=self.config.rays.quadrature,
            interp=self.config.rays.interp)
        lam = [float(v) for v in host(lam)]
        self._log(event="update_spectrum", epoch=epoch, rank=rank, lam=lam,
                  kappa_bound=lam[0])

    def run(self, poll_s: float = 2.0, max_epochs: int = None):
        """Poll until at least ``max_epochs`` have been assimilated
        (forever when None). The bound is checked between polls at file
        granularity, so a poll that ingests a multi-epoch file may finish
        past it; the return value is the exact count."""
        done = 0
        while max_epochs is None or done < max_epochs:
            n = self.process_available()
            done += n
            if n == 0:
                time.sleep(poll_s)
        return done
