"""Demo: nonlinear bent-ray tomography — re-trace rays through the
updated model each iteration (the reference's calc_rays-inside-the-loop,
SURVEY.md §3.1) and compare against the frozen-at-prior linearisation.

Strong-bending regime: 30 MHz through a dense plasma blob bends paths by
~100 km, so the linearisation's frozen paths carry real model error.

Run:  python -m ionotomo_tpu_torch.examples.bent_retrace [--outdir OUT]
          [--frequency-mhz 30] [--outer 4] [--device cpu] [--no-plots]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import parser

N_STEPS = 48
LENGTH_KM = 1000.0


def world(device):
    """The example's world: the grid, the prior (a 2e12 Chapman peak), the
    truth (the prior plus a blob at 320 km), the ray origins and
    directions (12 antennas × 6 directions, rk4 at ``N_STEPS`` through
    ``LENGTH_KM``), and the numpy generator whose next draw is the
    observation noise."""
    from ..core.grids import Grid3D
    from ..geometry import rays as rays_mod
    from ..models import chapman

    grid = Grid3D.from_bounds((-400, -400, 0.0), (400, 400, 1100.0),
                              (24, 24, 24), device=device)
    m_prior = chapman.log_parametrize(
        chapman.chapman_field(grid, n_peak=2e12))
    pts = grid.meshgrid()
    blob = 0.7 * np.exp(-np.sum(
        (pts - np.array([60.0, -40.0, 320.0])) ** 2
        / np.array([2 * 80.0**2, 2 * 80.0**2, 2 * 120.0**2]), -1))
    m_true = m_prior + torch.as_tensor(blob, dtype=torch.float32,
                                       device=device)

    rng = np.random.default_rng(2)
    na, nd = 12, 6
    ants = np.concatenate([rng.uniform(-60, 60, (na, 2)),
                           np.zeros((na, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.1, 0.5, nd)
    az = rng.uniform(0, 2 * np.pi, nd)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    o, d = rays_mod.make_ray_batch(torch.as_tensor(ants, device=device),
                                   torch.as_tensor(dirs, device=device))
    return dict(grid=grid, m_prior=m_prior, m_true=m_true, origins=o,
                directions=d, na=na, nd=nd, rng=rng)


def run(outdir="retrace_out", frequency_mhz=30.0, outer=4, device=None,
        plots=True):
    """The reference example's workflow; returns its printed numbers: the
    rmse over the ray-covered voxels of the frozen solve and of the
    prior, and of each re-trace iteration with its residual."""
    from ..device import host, resolve
    from ..forward import tec as tec_mod
    from ..geometry import fermat
    from ..inversion import solvers
    from ..inversion.priors import GPCovariance

    dev = resolve(device)
    os.makedirs(outdir, exist_ok=True)
    w = world(dev)
    grid, m_prior, m_true = w["grid"], w["m_prior"], w["m_true"]
    o, d, na, nd = w["origins"], w["directions"], w["na"], w["nd"]
    freq = frequency_mhz * 1e6

    # observations: bent TEC through the TRUE field + noise
    _, tau = fermat.trace_rays(m_true, grid, o, d, freq, LENGTH_KM,
                               n_steps=N_STEPS, keep_path=False)
    tau = host(tau).reshape(na, nd)
    d_obs = torch.as_tensor(
        tau - tau[0:1] + w["rng"].normal(0, 50.0, (na, nd)).astype(
            np.float32), device=dev)
    noise = 50.0
    cov = GPCovariance.create(grid, sigma=0.5, length_scale=120.0,
                              kind="sqexp")

    def trace(mf):
        return fermat.trace_rays(mf, grid, o, d, freq, LENGTH_KM,
                                 n_steps=N_STEPS, keep_path=True)[0]

    rb0 = trace(m_prior)
    cover = host(tec_mod.ray_coverage(grid, rb0))
    mask = cover > 0.05 * cover.max()
    truth = host(m_true)

    def rms(m):
        e = (host(m) - truth)[mask]
        return float(np.sqrt((e ** 2).mean()))

    res_frozen = solvers.map_gauss_newton(
        grid, rb0, d_obs, noise, m_prior, cov, num_directions=nd, i0=0,
        gn_iters=outer, cg_iters=30)
    out = dict(rmse_frozen=rms(res_frozen.m), rmse_prior=rms(m_prior),
               rmse_retraced=[], residual_retraced=[])
    m_k = m_prior
    for _ in range(outer):
        rb = trace(m_k)
        res = solvers.map_gauss_newton(
            grid, rb, d_obs, noise, m_prior, cov, num_directions=nd, i0=0,
            gn_iters=1, cg_iters=30, m0=m_k)
        m_k = res.m
        out["rmse_retraced"].append(rms(m_k))
        out["residual_retraced"].append(float(res.residual_norm))

    if plots:
        # a slice through the blob: truth vs frozen vs re-traced
        from . import pyplot
        plt = pyplot()
        k = int(np.argmin(np.abs(host(grid.axes()[2]) - 320.0)))
        prior = host(m_prior)
        fig, axes = plt.subplots(1, 3, figsize=(12, 3.6))
        for ax, (title, m) in zip(axes, [("truth", m_true),
                                         ("frozen", res_frozen.m),
                                         ("re-traced", m_k)]):
            im = ax.imshow(host(m)[:, :, k].T - prior[:, :, k].T,
                           origin="lower", cmap="magma")
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        out["figure"] = os.path.join(outdir, "retrace_vs_frozen.png")
        fig.savefig(out["figure"], dpi=110, bbox_inches="tight")
        plt.close(fig)
    return out


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--outdir", default="retrace_out")
    ap.add_argument("--frequency-mhz", type=float, default=30.0)
    ap.add_argument("--outer", type=int, default=4)
    args = ap.parse_args(argv)
    r = run(args.outdir, args.frequency_mhz, args.outer, device=args.device,
            plots=not args.no_plots)
    print(f"frozen linearisation : rmse {r['rmse_frozen']:.4f} "
          f"(prior {r['rmse_prior']:.4f})")
    for it, (e, res) in enumerate(zip(r["rmse_retraced"],
                                      r["residual_retraced"])):
        print(f"re-trace iteration {it}: rmse {e:.4f} (residual {res:.1f})")
    if "figure" in r:
        print(f"wrote {r['figure']}")


if __name__ == "__main__":
    main()
