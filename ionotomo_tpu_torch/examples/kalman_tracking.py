"""Demo: track a drifting turbulent ionosphere with the frozen-flow Kalman
filter, including automatic wind estimation.

Run:  python -m ionotomo_tpu_torch.examples.kalman_tracking [--outdir OUT]
          [--times 6] [--grid 24] [--device cpu] [--no-plots]
"""
from __future__ import annotations

import os

import numpy as np

from . import parser

WIND_TRUE = (0.25, 0.1, 0.0)


def run(outdir="kalman_out", times=6, grid=24, device=None, plots=True,
        white=None):
    """The reference example's workflow; returns its printed numbers:
    ``records`` (the pipeline's metrics, without ``t_wall``), the
    whitened residuals ``pre``/``post`` per step, and the model rmse of
    the filtered field ``rmse`` and of the static background
    ``rmse_background`` per step. With ``plots`` the filtered sequence is
    written as ``evolution.gif``. ``white``: the truth's turbulence white
    noise, (grid,)*3 standard normals."""
    from ..config import (EngineConfig, GridConfig, PriorConfig, RayConfig,
                          RuntimeConfig, SolverConfig)
    from ..data.synth import generate_example_datapack
    from ..device import resolve
    from ..inversion.pipeline import InversionPipeline

    dev = resolve(device)
    os.makedirs(outdir, exist_ok=True)
    print(f"simulating {times} timesteps, wind {WIND_TRUE} km/s ...")
    dp, truth = generate_example_datapack(
        n_antennas=20, n_directions=8, n_times=times, mjd0=58000.45,
        dt_s=60.0, grid_shape=(grid,) * 3, noise_tecu=2e-3,
        turbulence_amp=0.3, wind_kmps=WIND_TRUE, seed=1, white=white,
        device=dev)

    cfg = EngineConfig(
        grid=GridConfig(shape=(grid,) * 3),
        rays=RayConfig(n_samples=49),
        prior=PriorConfig(sigma=0.3, length_scale_km=100.0,
                          kind="von_karman"),
        solver=SolverConfig(solver="kalman", cg_iters=25,
                            kalman_fade=0.98),
        runtime=RuntimeConfig(
            checkpoint_dir=os.path.join(outdir, "ckpt"),
            metrics_path=os.path.join(outdir, "metrics.jsonl")),
    )
    print("filtering (wind estimated from the first two snapshots) ...")
    pipe = InversionPipeline(dp, cfg, device=dev)
    sol = pipe.run(resume=False)
    records = [{k: v for k, v in rec.items() if k != "t_wall"}
               for rec in pipe.metrics.read_all()]

    err = [float(np.sqrt(np.mean((sol.m[t] - truth["m"][t]) ** 2)))
           for t in range(times)]
    err_bg = [float(np.sqrt(np.mean((truth["m_background"]
                                     - truth["m"][t]) ** 2)))
              for t in range(times)]
    if plots:
        from ..plotting import plot_tools
        plot_tools.animate_model(sol, filename=os.path.join(outdir,
                                                            "evolution.gif"))
    return dict(records=records,
                pre=[float(v) for v in sol.diagnostics["pre_residuals"]],
                post=[float(v) for v in sol.diagnostics["post_residuals"]],
                rmse=err, rmse_background=err_bg, outdir=outdir)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--outdir", default="kalman_out")
    ap.add_argument("--times", type=int, default=6)
    ap.add_argument("--grid", type=int, default=24)
    args = ap.parse_args(argv)
    r = run(args.outdir, args.times, args.grid, device=args.device,
            plots=not args.no_plots)
    for rec in r["records"]:
        print("  ", rec)
    print("whitened residuals per step:")
    for t in range(args.times):
        print(f"  t={t}: pre {r['pre'][t]:9.1f} -> post {r['post'][t]:9.1f}")
    print("model rmse filtered vs static background:")
    for t in range(args.times):
        print(f"  t={t}: {r['rmse'][t]:.4f} vs {r['rmse_background'][t]:.4f}")
    print(f"outputs in {args.outdir}/")


if __name__ == "__main__":
    main()
