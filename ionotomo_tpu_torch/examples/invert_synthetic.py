"""End-to-end demo: simulate a LOFAR-like observation, invert it, plot.

Run:  python -m ionotomo_tpu_torch.examples.invert_synthetic [--bent]
          [--outdir OUT] [--device cpu] [--no-plots]

``save_h5=False`` (``--no-h5``) writes neither the observation nor the
solution file: the h5 files need h5py, which a machine may lack.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import parser


def run(outdir="demo_out", bent=False, antennas=30, directions=10, grid=32,
        turbulence=0.3, device=None, plots=True, white=None, save_h5=True,
        cg_iters=100):
    """The reference example's workflow; returns its printed numbers:
    ``records`` (the pipeline's metrics, without ``t_wall``), the model
    rmse of the prior and the posterior over all voxels and over the
    ray-covered ones (``*_covered``), and ``covered_fraction``.
    ``white``: the truth's turbulence white noise, (grid,)*3 standard
    normals (``data.synth.generate_example_datapack``); ``cg_iters``: the
    solve's CG depth (the reference's 100)."""
    from .. import constants
    from ..config import (EngineConfig, GridConfig, PriorConfig, RayConfig,
                          RuntimeConfig, SolverConfig)
    from ..data.synth import generate_example_datapack
    from ..device import host, resolve
    from ..forward import tec as tec_mod
    from ..inversion.pipeline import InversionPipeline

    dev = resolve(device)
    os.makedirs(outdir, exist_ok=True)
    print("generating synthetic observation ...")
    dp, truth = generate_example_datapack(
        n_antennas=antennas, n_directions=directions, n_times=1,
        mjd0=58000.45, grid_shape=(grid,) * 3, noise_tecu=1e-3,
        turbulence_amp=turbulence, n_samples=65, white=white, device=dev)
    if save_h5:
        dp.save(os.path.join(outdir, "observation.h5"))

    cfg = EngineConfig(
        grid=GridConfig(shape=(grid,) * 3),
        rays=RayConfig(n_samples=65, bent=bent),
        # matched prior: the synthetic world's turbulence IS a von Kármán
        # field with outer scale 100 km and this amplitude
        prior=PriorConfig(sigma=turbulence, length_scale_km=100.0,
                          kind="von_karman"),
        solver=SolverConfig(gn_iters=1, cg_iters=cg_iters),
        runtime=RuntimeConfig(
            checkpoint_dir=os.path.join(outdir, "ckpt"),
            metrics_path=os.path.join(outdir, "metrics.jsonl")),
    )
    print("inverting ...")
    pipe = InversionPipeline(dp, cfg, device=dev)
    sol = pipe.run(resume=False)
    if save_h5:
        sol.save(os.path.join(outdir, "solution.h5"))
    records = [{k: v for k, v in rec.items() if k != "t_wall"}
               for rec in pipe.metrics.read_all()]

    if plots:
        from ..plotting import plot_tools
        plot_tools.plot_datapack(dp, filename=os.path.join(outdir,
                                                           "datapack.png"))
        truth_ne = constants.K_NE * np.exp(truth["m"][0])
        plot_tools.plot_model_slices(
            sol, truth=truth_ne, filename=os.path.join(outdir, "slices.png"))
    # evaluate where the data actually constrain the model: the Jacobian
    # sensitivity |∂Σg/∂m| (ne-weighted), not raw path length
    rb = pipe.rays_for_time(0)
    m = pipe.m_prior.detach().clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(tec_mod.tec(m, pipe.grid, rb).sum(), m)
    sens = np.abs(host(grad))
    mask = sens > np.quantile(sens[sens > 1e-12 * sens.max()], 0.75)

    def rmse(field):
        d = host(field) - truth["m"][0]
        return (float(np.sqrt(np.mean(d ** 2))),
                float(np.sqrt(np.mean(d[mask] ** 2))))

    ep, epc = rmse(pipe.m_prior)
    es, esc = rmse(sol.m[0])
    return dict(records=records, rmse_prior=ep, rmse_posterior=es,
                rmse_covered_prior=epc, rmse_covered_posterior=esc,
                covered_fraction=float(mask.mean()), outdir=outdir)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--outdir", default="demo_out")
    ap.add_argument("--bent", action="store_true",
                    help="trace bent rays through the prior model")
    ap.add_argument("--antennas", type=int, default=30)
    ap.add_argument("--directions", type=int, default=10)
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--turbulence", type=float, default=0.3)
    ap.add_argument("--no-h5", action="store_true",
                    help="write no h5 files (no h5py needed)")
    args = ap.parse_args(argv)
    r = run(args.outdir, args.bent, args.antennas, args.directions,
            args.grid, args.turbulence, device=args.device,
            plots=not args.no_plots, save_h5=not args.no_h5)
    for rec in r["records"]:
        print("  ", rec)
    print(f"model rmse        : prior {r['rmse_prior']:.4f} -> posterior "
          f"{r['rmse_posterior']:.4f}")
    print(f"rmse (ray-covered): prior {r['rmse_covered_prior']:.4f} -> "
          f"posterior {r['rmse_covered_posterior']:.4f} "
          f"({r['covered_fraction'] * 100:.0f}% of voxels)")
    print(f"outputs in {args.outdir}/")


if __name__ == "__main__":
    main()
