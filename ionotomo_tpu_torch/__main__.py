"""Command-line interface of the port: simulate, invert, predict, info,
serve.

  python -m ionotomo_tpu_torch simulate --out obs.h5 [--antennas 50 ...]
  python -m ionotomo_tpu_torch invert obs.h5 --out solution.h5 [--solver ...]
  python -m ionotomo_tpu_torch predict solution.h5 obs.h5 --out pred.h5 [--rm]
  python -m ionotomo_tpu_torch info obs.h5|solution.h5
  python -m ionotomo_tpu_torch serve IN_DIR OUT_DIR [--solver enkf] ...

The reference CLI's subcommands (``ionotomo_tpu``) with their arguments
and defaults; ``simulate``, ``invert``, ``predict`` and ``serve`` take
``--device`` (the card unless named; ``cpu`` runs the plain PyTorch
versions). The arithmetic of ``invert``, ``predict`` and ``serve`` is
callable without files (``invert_config``, ``predict``,
``serve_config``).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple

import numpy as np
import torch


def _interp_arg_opt(value):
    """--interp-inner: empty string = single field model."""
    return _interp_arg(value) if value else ""


def _interp_arg(value):
    """Validate --interp: "cubic" | "zp" | "zp<order>" | "zpc" |
    "zpc<order>" (order = xy-prefilter Neumann order;
    core.boxspline.zp_order / core.zpcubic.zpc_order)."""
    if value == "cubic":
        return value
    try:
        if value.startswith("zpc"):
            from .core.zpcubic import zpc_order
            zpc_order(value)
        else:
            from .core.boxspline import zp_order
            zp_order(value)
        return value
    except ValueError:
        raise SystemExit(
            f"--interp must be 'cubic', 'zp', 'zp<order>=2>', 'zpc', or "
            f"'zpc<order>=2>' (e.g. zp4), got {value!r}")


def _prior_length(values):
    """Validate --prior-length arity: 1 (isotropic) or 3 (Lx Ly Lz)."""
    if len(values) not in (1, 3):
        raise SystemExit(
            f"--prior-length takes 1 (isotropic) or 3 (Lx Ly Lz) values, "
            f"got {len(values)}: {values}")
    return tuple(values) if len(values) == 3 else values[0]


def serve_config(args):
    """The ``EngineConfig`` a ``serve`` command line describes."""
    from .config import (EngineConfig, GridConfig, PhysicsConfig,
                         PriorConfig, RayConfig, SolverConfig)

    return EngineConfig(
        physics=PhysicsConfig(time_varying_clim=args.time_varying_clim),
        grid=GridConfig(shape=(args.grid,) * 3),
        rays=RayConfig(n_samples=args.samples,
                       quadrature=args.quadrature,
                       interp=args.interp,
                       interp_inner=args.interp_inner,
                       inner_samples=args.inner_samples,
                       beam_noise=args.beam_noise),
        prior=PriorConfig(sigma=args.prior_sigma,
                          length_scale_km=_prior_length(args.prior_length),
                          kind=args.prior_kind),
        solver=SolverConfig(solver=args.solver, cg_iters=args.cg_iters,
                            kalman_fade=args.fade,
                            wind_adapt_iters=args.wind_adapt,
                            wind_shear=args.wind_shear,
                            adapt_r=args.adapt_r,
                            diag_spectrum_every=args.diag_spectrum),
    )


def cmd_simulate(args):
    from .data.synth import generate_example_datapack
    from .device import host

    dp, truth = generate_example_datapack(
        n_antennas=args.antennas, n_directions=args.directions,
        n_times=args.times, mjd0=args.mjd0, grid_shape=(args.grid,) * 3,
        noise_tecu=args.noise_tecu, turbulence_amp=args.turbulence,
        seed=args.seed, curved_earth=args.curved_earth, device=args.device)
    dp.save(args.out)
    print(f"wrote {args.out}: dtec shape {dp.shape}, "
          f"ref antenna {dp.array.labels[dp.ref_antenna]}")
    if args.truth_out:
        from .inversion.solution import Solution
        Solution(truth["grid"], truth["m"]).save(args.truth_out)
        print(f"wrote ground truth to {args.truth_out}")
    if args.ionosonde_out:
        import numpy as np
        from .data import ionosonde as iono
        grid = truth["grid"]
        o = host(grid.origin).astype(np.float64)
        span = host(grid.spacing).astype(np.float64) * (
            np.asarray(grid.shape) - 1)
        # stations in the central half of the footprint so every probe
        # stays inside the grid (out-of-grid probes are refused)
        rng = np.random.default_rng(args.seed + 1)
        xy = np.stack([rng.uniform(o[a] + 0.25 * span[a],
                                   o[a] + 0.75 * span[a],
                                   args.ionosonde_stations)
                       for a in (0, 1)], -1)
        probes = iono.bottomside_probes(truth["m"], grid, xy,
                                        noise_log=args.ionosonde_noise,
                                        seed=args.seed + 1)
        iono.probes_to_npz(args.ionosonde_out, probes)
        print(f"wrote {int(probes.values.shape[0])} synthetic ionosonde "
              f"probe(s) from {args.ionosonde_stations} station(s) to "
              f"{args.ionosonde_out}")


def invert_config(args):
    """The ``EngineConfig`` an ``invert`` command line describes."""
    from .config import (EngineConfig, GridConfig, PhysicsConfig,
                         PriorConfig, RayConfig, RuntimeConfig,
                         SolverConfig)

    return EngineConfig(
        physics=PhysicsConfig(apriori_model=args.apriori_model,
                              curved_earth=args.curved_earth,
                              time_varying_clim=args.time_varying_clim),
        grid=GridConfig(shape=(args.grid,) * 3),
        rays=RayConfig(bent=args.bent, n_samples=args.samples,
                       quadrature=args.quadrature,
                       interp=args.interp,
                       interp_inner=args.interp_inner,
                       inner_samples=args.inner_samples,
                       n_steps=args.n_steps,
                       retrace_every=args.retrace_every,
                       beam_noise=args.beam_noise),
        prior=PriorConfig(sigma=args.prior_sigma,
                          length_scale_km=_prior_length(args.prior_length),
                          kind=args.prior_kind,
                          auto_select=args.auto_prior,
                          fit_noise=args.fit_noise),
        solver=SolverConfig(solver=args.solver, gn_iters=args.gn_iters,
                            cg_iters=args.cg_iters,
                            warm_start=args.warm_start,
                            kalman_chunk=args.kalman_chunk,
                            kalman_fade=args.fade,
                            estimate_profile=args.estimate_profile,
                            enkf_spectrum_blend=args.enkf_spectrum_blend,
                            enkf_shard=args.enkf_shard,
                            wind_adapt_iters=args.wind_adapt,
                            wind_shear=args.wind_shear,
                            posterior_samples=args.posterior_samples,
                            noise_adapt_every=args.noise_adapt,
                            diag_spectrum_every=args.diag_spectrum),
        runtime=RuntimeConfig(checkpoint_dir=args.checkpoint_dir,
                              metrics_path=args.metrics),
    )


def cmd_invert(args):
    from .data.datapack import DataPack
    from .inversion.pipeline import InversionPipeline

    dp = DataPack.load(args.datapack)
    if args.auto_flag:
        from .data.selection import flag_outliers
        n = flag_outliers(dp, threshold=args.auto_flag)
        print(f"auto-flagged {n} outlier sample(s) "
              f"(threshold {args.auto_flag} median steps)")
    pipe = InversionPipeline(dp, invert_config(args), device=args.device)
    anchors = None
    if args.vtec_anchors:
        from .inversion.anchors import anchors_from_npz
        anchors = anchors_from_npz(pipe.grid, args.vtec_anchors)
    probes = None
    if args.ionosonde:
        from .data.ionosonde import probes_from_npz
        probes = probes_from_npz(pipe.grid, args.ionosonde)
    sol = pipe.run(resume=args.resume, anchors=anchors,
                   anchor_mode=args.anchor_mode, probes=probes)
    sol.save(args.out)
    print(f"wrote {args.out}: {sol.num_times} timestep(s), "
          f"grid {sol.grid.shape}")
    for rec in pipe.metrics.read_all():
        rec.pop("t_wall", None)
        print("  ", json.dumps(rec))


class Prediction(NamedTuple):
    """What ``predict`` returns: the predicted dTEC (Na, Nt, Nd), the
    differential Faraday RM (Na, Nt, Nd; None without ``rm``), and the
    rms of the observed dTEC and of the residual over unflagged samples
    (working units)."""

    dtec: np.ndarray
    drm: np.ndarray | None
    observed_rms: float
    residual_rms: float


def predict_rays(m_t, grid, antennas, directions, frequency_hz,
                 bent=False, samples=129, max_length=1000.0, n_steps=64,
                 interp="cubic"):
    """One timestep's (antenna x direction) bundle: straight, sampled at
    ``samples`` points, or bent, traced through ``m_t`` by the leapfrog
    tracer with its path (K1c on cubic, K1 on zp on the card)."""
    from .geometry import fermat, rays as rays_mod

    origins, dvecs = rays_mod.make_ray_batch(antennas, directions)
    if bent:
        # bent bundle + paired quadrature (cancellation-free), the
        # same forward the inversion pipeline uses, not tau-minus-tau
        rb, _ = fermat.trace_rays(m_t, grid, origins, dvecs, frequency_hz,
                                  max_length, n_steps=n_steps,
                                  keep_path=True, method="leapfrog",
                                  interp=interp)
        return rb
    return rays_mod.sample_straight_rays(origins, dvecs,
                                         max_length_km=max_length,
                                         n_samples=samples)


def predict(dp, sol, samples=129, quadrature="hermite", interp="cubic",
            max_length=1000.0, bent=False, n_steps=64, rm=False,
            device=None) -> Prediction:
    """Forward-model a Solution onto a DataPack's geometry, one timestep
    at a time on ``device`` (the card unless named): the predicted dTEC
    (``tec.dtec_paired_q``) and, with ``rm``, the differential Faraday RM
    of the same bundle (``rm.drm``, dipole B; its n_e gathered on cubic
    whatever ``interp`` is, as in the reference). A one-timestep solution
    broadcasts over the DataPack's timesteps."""
    from .device import host, resolve
    from .forward import tec as tec_mod

    dev = resolve(device)
    dev_arrays = dp.to_device_arrays()
    ants = torch.as_tensor(dev_arrays["antennas_enu"], device=dev)
    dirs = torch.as_tensor(dev_arrays["directions_enu"], device=dev)
    i0 = dev_arrays["ref_antenna"]
    na, nt, nd = dp.shape
    grid = sol.grid.to(dev)
    if sol.num_times == nt:
        m_seq = sol.m
    elif sol.num_times == 1:
        m_seq = np.broadcast_to(sol.m[0], (nt,) + sol.m.shape[1:])
    else:
        raise SystemExit(
            f"solution has {sol.num_times} timesteps but the datapack has "
            f"{nt}; select matching times or use a single-timestep "
            f"solution (which broadcasts)")
    b_fn = drm_fn = None
    if rm:
        from .forward.rm import drm as drm_fn
        from .models.geomagnetic import dipole_b_enu_fn
        b_fn = dipole_b_enu_fn(dp.array.enu_frame, device=dev)
    pred, drm_out = [], []
    for t in range(nt):
        m_t = torch.as_tensor(np.array(m_seq[t], np.float32), device=dev)
        rb = predict_rays(m_t, grid, ants, dirs[t], dp.frequency_hz, bent,
                          samples, max_length, n_steps, interp)
        pred.append(tec_mod.dtec_paired_q(m_t, grid, rb, nd, i0, quadrature,
                                          interp))
        if rm:
            # same bundle as the dTEC: bent RM along bent paths
            drm_out.append(drm_fn(m_t, grid, rb, b_fn, nd, i0))
    pred = host(torch.stack(pred, 1))
    drm_out = host(torch.stack(drm_out, 1)) if rm else None
    ok = ~dp.flags
    res = (pred - dp.dtec)[ok]
    obs = dp.dtec[ok]
    return Prediction(pred, drm_out, float(np.sqrt(np.mean(obs**2))),
                      float(np.sqrt(np.mean(res**2))))


def cmd_predict(args):
    """Forward-model a saved Solution onto a DataPack's geometry, the
    serving-side workflow (``predict``): residual stats against the
    observed dtec, and an output DataPack (or h5parm) holding the
    predictions, with the dRM appended as dataset ``drm``."""
    from .data.datapack import DataPack
    from .inversion.solution import Solution

    dp = DataPack.load(args.datapack)
    sol = Solution.load(args.solution, device=args.device)
    na, nt, nd = dp.shape
    p = predict(dp, sol, samples=args.samples, quadrature=args.quadrature,
                interp=args.interp, max_length=args.max_length,
                bent=args.bent, n_steps=args.n_steps, rm=args.rm,
                device=args.device)
    print(f"predicted {na}x{nt}x{nd} dTEC "
          f"({'bent' if args.bent else 'straight'} rays)")
    print(f"  observed rms {p.observed_rms:.2f}, residual rms "
          f"{p.residual_rms:.2f} (working units, unflagged)")
    out = DataPack(dp.array, dp.directions, dp.times, dtec=p.dtec,
                   flags=dp.flags, noise_std=dp.noise_std,
                   ref_antenna=dp.ref_antenna,
                   frequency_hz=dp.frequency_hz,
                   frame_model=dp.frame_model)
    if args.h5parm:
        if args.rm:
            raise SystemExit(
                "--h5parm with --rm is not supported: differential RM has "
                "no losoto soltab representation here and a stray root "
                "dataset would break pipeline consumers — write a "
                "DataPack file (drop --h5parm) for RM output")
        out.to_h5parm(args.out)
        print(f"wrote {args.out} (losoto h5parm tec000 soltab — feed "
              f"straight back to the LOFAR calibration pipeline)")
    else:
        out.save(args.out)
        print(f"wrote {args.out}")
    if args.rm:
        import h5py
        with h5py.File(args.out, "a") as f:
            f.create_dataset("drm", data=p.drm)
        print(f"  + differential Faraday RM (rad/m^2) in dataset 'drm', "
              f"range [{p.drm.min():.3f}, {p.drm.max():.3f}]")


def cmd_info(args):
    import h5py

    with h5py.File(args.path, "r") as f:
        if "dtec" in f:
            print(f"DataPack: {args.path}")
            print(f"  antennas: {f['antennas/itrs_km'].shape[0]}  "
                  f"times: {f['times/mjd'].shape[0]}  "
                  f"directions: {f['directions/radec'].shape[0]}")
            print(f"  ref antenna index: {f.attrs['ref_antenna']}  "
                  f"frequency: {f.attrs['frequency_hz']/1e6:.1f} MHz")
            d = f["dtec"][:]
            print(f"  dtec range [{d.min():.3f}, {d.max():.3f}] "
                  f"(working units), flagged "
                  f"{100.0 * f['flags'][:].mean():.1f}%")
        elif "m" in f:
            print(f"Solution: {args.path}")
            print(f"  timesteps: {f['m'].shape[0]}  "
                  f"grid: {tuple(int(s) for s in f['grid/shape'][:])}")
            if f.attrs.get("config"):
                print(f"  config: {f.attrs['config'][:160]}...")
        elif any(k.startswith("sol") and isinstance(f[k], h5py.Group)
                 for k in f):
            print(f"h5parm: {args.path}")
            for ss_name in (k for k in f
                            if k.startswith("sol")
                            and isinstance(f[k], h5py.Group)):
                ss = f[ss_name]
                soltabs = [k for k in ss
                           if isinstance(ss[k], h5py.Group)]
                na = ss["antenna"].shape[0] if "antenna" in ss else "?"
                nd = ss["source"].shape[0] if "source" in ss else "?"
                print(f"  {ss_name}: antennas {na}, sources {nd}, "
                      f"soltabs {soltabs}")
            print("  load with DataPack.from_h5parm(path)")
        else:
            print("unrecognised file")


def cmd_serve(args):
    from .serving import EpochService

    svc = EpochService(args.watch_dir, args.out_dir, serve_config(args),
                       wind_kmps=args.wind,
                       vtec_anchors_npz=args.vtec_anchors,
                       device=args.device)
    print(f"serving: watching {args.watch_dir} -> {args.out_dir} "
          f"({args.solver}, {svc.device})")
    done = svc.run(poll_s=args.poll_s, max_epochs=args.max_epochs)
    print(f"assimilated {done} epoch(s)")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m ionotomo_tpu_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = ("torch device (default: the card, cuda; 'cpu' runs the "
                   "plain PyTorch versions)")

    s = sub.add_parser("simulate", help="generate a synthetic DataPack")
    s.add_argument("--out", required=True)
    s.add_argument("--truth-out", default=None)
    s.add_argument("--antennas", type=int, default=50)
    s.add_argument("--directions", type=int, default=10)
    s.add_argument("--times", type=int, default=1)
    s.add_argument("--mjd0", type=float, default=58000.45)
    s.add_argument("--grid", type=int, default=64)
    s.add_argument("--noise-tecu", type=float, default=1e-3)
    s.add_argument("--turbulence", type=float, default=0.3)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--curved-earth", action="store_true",
                   help="build the truth world with curved-Earth "
                        "geometry (true altitudes + solar terminator)")
    s.add_argument("--ionosonde-out", default=None,
                   help="also write synthetic bottomside ionosonde "
                        "soundings of the truth world to this npz "
                        "(the invert --ionosonde schema; name it "
                        "*.sounding.npz and drop it in a serve watch "
                        "directory to stream it)")
    s.add_argument("--ionosonde-stations", type=int, default=2,
                   help="number of synthetic sounder stations")
    s.add_argument("--ionosonde-noise", type=float, default=0.05,
                   help="log-space (≈relative) sounding noise")
    s.add_argument("--device", default=None, help=device_help)
    s.set_defaults(fn=cmd_simulate)

    i = sub.add_parser("invert", help="invert a DataPack to a Solution")
    i.add_argument("datapack")
    i.add_argument("--out", required=True)
    i.add_argument("--grid", type=int, default=64)
    i.add_argument("--samples", type=int, default=129)
    i.add_argument("--bent", action="store_true")
    i.add_argument("--n-steps", type=int, default=64,
                   help="bent-ray integrator steps (solver-grade: 64)")
    i.add_argument("--retrace-every", type=int, default=0,
                   help="bent only: re-trace rays through the iterate "
                        "every N GN iterations (0 = frozen at prior)")
    i.add_argument("--beam-noise", type=int, default=0, metavar="P",
                   help="strong-turbulence error bar: trace a P-path "
                        "stochastic Fresnel beam per ray each epoch and "
                        "inflate C_d in quadrature with the chaotic dTEC "
                        "spread (0 = off)")
    i.add_argument("--enkf-spectrum-blend", type=float, default=0.0,
                   help="enkf: adaptive spectral gain weight (0=off; not "
                        "ported: any other value raises)")
    i.add_argument("--enkf-shard", choices=("rays", "members"),
                   default="rays",
                   help="enkf multi-device axis: 'rays' (one device) or "
                        "'members' (multi-GPU, not ported: raises)")
    i.add_argument("--kalman-chunk", type=int, default=8,
                   help="kalman: timesteps per chunk / checkpoint")
    i.add_argument("--solver", default="map_gauss_newton",
                   choices=["map_gauss_newton", "lsqr_smoothness",
                            "steepest", "batched_gn", "robust_gn",
                            "kalman", "enkf"])
    i.add_argument("--gn-iters", type=int, default=2)
    i.add_argument("--cg-iters", type=int, default=40)
    i.add_argument("--posterior-samples", type=int, default=0,
                   metavar="N",
                   help="snapshot modes: draw N linearised-posterior RTO "
                        "samples per timestep (one batched CG) and store "
                        "the per-voxel std in the solution "
                        "(diagnostics/std_seq)")
    i.add_argument("--noise-adapt", type=int, default=0, metavar="N",
                   help="kalman/enkf: adaptive R, re-fit a common noise "
                        "rescaling every N-th chunk boundary by exact "
                        "evidence on that epoch's innovation "
                        "(checkpointed)")
    i.add_argument("--diag-spectrum", type=int, default=0, metavar="N",
                   help="kalman/enkf: log the update operator's top-rank "
                        "spectrum (condition-number bound kappa_bound) "
                        "as an update_spectrum metrics event every N-th "
                        "chunk boundary")
    i.add_argument("--estimate-profile", action="store_true",
                   help="MAP-estimate the profile parameters from "
                        "timestep-0 data + the --vtec-anchors rows "
                        "before solving (anchors required; slant "
                        "geometry recommended): the Chapman (N_peak, "
                        "h_peak, H), or with --apriori-model "
                        "multi_chapman the per-layer E/F1/F2 parameters")
    i.add_argument("--fade", type=float, default=1.0,
                   help="kalman/enkf: per-step pull toward the "
                        "climatology (1.0 = pure frozen flow; <1 "
                        "enables the clim pull)")
    i.add_argument("--time-varying-clim", action="store_true",
                   help="kalman/enkf: recompute the climatological "
                        "fade-pull target per epoch from the epoch's "
                        "solar zenith; needs --fade < 1")
    i.add_argument("--quadrature", default="hermite",
                   choices=["simpson", "hermite"],
                   help="straight-ray operator quadrature rule")
    i.add_argument("--interp", default="cubic", type=_interp_arg,
                   help="C1 field model for every interpolation (tracer "
                        "and operators): cubic, zp[<order>], zpc[<order>]")
    i.add_argument("--inner-samples", type=int, default=0,
                   help="mixed-fidelity solves: the linear solve's "
                        "Jacobian from a coarse subsample at this many "
                        "samples; needs (samples-1) %% (inner-samples-1) "
                        "== 0")
    i.add_argument("--interp-inner", default="", type=_interp_arg_opt,
                   help="mixed field-model fidelity: the linear solve's "
                        "Jacobian on this model, residuals on --interp")
    i.add_argument("--warm-start", action="store_true",
                   help="snapshot GN modes: carry the whitened Krylov "
                        "solution across GN iterations / IRLS rounds / "
                        "re-trace calls")
    i.add_argument("--wind-shear", action="store_true",
                   help="kalman/enkf: rigid + linear-in-height vertical "
                        "shear drift state")
    i.add_argument("--wind-adapt", type=int, default=0, metavar="N",
                   help="kalman/enkf: online wind tracking, N "
                        "innovation-GN refinements of the wind per epoch")
    i.add_argument("--prior-sigma", type=float, default=0.3)
    i.add_argument("--prior-length", type=float, nargs="+", default=[80.0],
                   metavar="L",
                   help="prior correlation length [km]: one value "
                        "(isotropic) or three (Lx Ly Lz)")
    i.add_argument("--prior-kind", default="von_karman")
    i.add_argument("--apriori-model", default="chapman",
                   choices=["chapman", "multi_chapman"],
                   help="a-priori n_e: single Chapman layer or the "
                        "E/F1/F2 stack")
    i.add_argument("--auto-flag", type=float, default=0.0, metavar="K",
                   help="flag samples whose epoch-to-epoch jump exceeds "
                        "K median steps before inverting "
                        "(data/selection.flag_outliers; 0 = off)")
    i.add_argument("--vtec-anchors", default=None,
                   help="npz with points_xy (A,2; ENU km), values_tecu "
                        "(A,), noise_tecu (scalar): external absolute "
                        "vertical-TEC constraints")
    i.add_argument("--anchor-mode", default="sequential",
                   choices=["sequential", "joint"])
    i.add_argument("--ionosonde", default=None,
                   help="npz with points_enu (P,3; ENU km), ne_m3 (P,), "
                        "noise_frac (scalar): ionosonde point-density "
                        "observations")
    i.add_argument("--curved-earth", action="store_true",
                   help="evaluate the a-priori profile at true altitude "
                        "above the curved Earth with a per-column solar "
                        "factor")
    i.add_argument("--auto-prior", nargs="?", const="gcv", default=False,
                   choices=["gcv", "evidence"],
                   help="select (sigma, L, kind) from the data at set-up: "
                        "'gcv' (generalised cross-validation; the "
                        "bare-flag default) or 'evidence' (marginal "
                        "likelihood)")
    i.add_argument("--fit-noise", action="store_true",
                   help="with --auto-prior evidence: also fit a common "
                        "noise-std rescaling rho and scale the run's "
                        "noise by rho*")
    i.add_argument("--checkpoint-dir", default="checkpoints")
    i.add_argument("--metrics", default="metrics.jsonl")
    i.add_argument("--resume", action="store_true")
    i.add_argument("--device", default=None, help=device_help)
    i.set_defaults(fn=cmd_invert)

    q = sub.add_parser("predict", help="forward-model a Solution onto a "
                                       "DataPack's geometry")
    q.add_argument("solution")
    q.add_argument("datapack")
    q.add_argument("--out", required=True)
    q.add_argument("--samples", type=int, default=129)
    q.add_argument("--quadrature", default="hermite",
                   choices=["simpson", "hermite"],
                   help="straight-ray prediction quadrature (matches the "
                        "inversion operator default)")
    q.add_argument("--interp", default="cubic", type=_interp_arg,
                   help="C1 field model (see invert --interp)")
    q.add_argument("--max-length", type=float, default=1000.0)
    q.add_argument("--bent", action="store_true")
    q.add_argument("--n-steps", type=int, default=64)
    q.add_argument("--rm", action="store_true",
                   help="also write differential Faraday RM (dipole B)")
    q.add_argument("--h5parm", action="store_true",
                   help="write the prediction as a losoto h5parm "
                        "(tec000 soltab) instead of a DataPack file")
    q.add_argument("--device", default=None, help=device_help)
    q.set_defaults(fn=cmd_predict)

    n = sub.add_parser("info", help="describe a DataPack/Solution file")
    n.add_argument("path")
    n.set_defaults(fn=cmd_info)

    v = sub.add_parser("serve", help="streaming service: watch a "
                                     "directory for DataPack epochs "
                                     "(and *.sounding.npz ionosonde "
                                     "files, assimilated as they "
                                     "arrive), filter online, emit "
                                     "Solutions")
    v.add_argument("watch_dir")
    v.add_argument("out_dir")
    v.add_argument("--solver", default="kalman",
                   choices=["kalman", "enkf"])
    v.add_argument("--grid", type=int, default=64)
    v.add_argument("--samples", type=int, default=65)
    v.add_argument("--cg-iters", type=int, default=30)
    v.add_argument("--quadrature", default="hermite",
                   choices=["simpson", "hermite"])
    v.add_argument("--interp", default="cubic", type=_interp_arg,
                   help="C1 field model: cubic, zp[<order>], zpc[<order>]")
    v.add_argument("--inner-samples", type=int, default=0,
                   help="mixed-fidelity per-epoch updates: the solve's "
                        "Jacobian from this many samples a ray")
    v.add_argument("--interp-inner", default="", type=_interp_arg_opt,
                   help="mixed field-model per-epoch updates: the "
                        "solve's Jacobian on this model")
    v.add_argument("--wind-shear", action="store_true",
                   help="rigid + vertical-shear drift state")
    v.add_argument("--wind-adapt", type=int, default=0, metavar="N",
                   help="online wind tracking: N innovation Gauss-Newton "
                        "refinements per epoch")
    v.add_argument("--beam-noise", type=int, default=0, metavar="P",
                   help="strong-turbulence error bar per epoch from a "
                        "beam of P paths a ray")
    v.add_argument("--diag-spectrum", type=int, default=0, metavar="N",
                   help="log an update_spectrum record (top-rank "
                        "eigenvalues + kappa_bound of the update "
                        "operator) into epochs.jsonl every N-th epoch")
    v.add_argument("--adapt-r", type=float, default=0.0, metavar="ALPHA",
                   help="streaming adaptive observation-noise scale: "
                        "EMA weight of the per-epoch innovation-"
                        "consistency noise MLE (0 = off; ~0.1 typical). "
                        "The learned scale multiplies each epoch's "
                        "noise, persists in state.npz, and is logged as "
                        "r_scale in epochs.jsonl")
    v.add_argument("--fade", type=float, default=1.0,
                   help="per-step pull toward the climatology (1.0 = "
                        "pure frozen flow; <1 enables the clim pull)")
    v.add_argument("--time-varying-clim", action="store_true",
                   help="recompute the climatological fade-pull target "
                        "per epoch from its solar zenith")
    v.add_argument("--prior-sigma", type=float, default=0.3)
    v.add_argument("--prior-length", type=float, nargs="+", default=[80.0],
                   metavar="L")
    v.add_argument("--prior-kind", default="von_karman")
    v.add_argument("--wind", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   metavar=("VX", "VY", "VZ"), help="bulk wind [km/s]")
    v.add_argument("--vtec-anchors", default=None,
                   help="npz with points_xy/values_tecu/noise_tecu: "
                        "per-epoch absolute-TEC anchoring of the filter")
    v.add_argument("--poll-s", type=float, default=2.0)
    v.add_argument("--max-epochs", type=int, default=None,
                   help="stop after N epochs (default: run forever)")
    v.add_argument("--device", default=None, help=device_help)
    v.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
