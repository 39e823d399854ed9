"""Demo: posterior uncertainty — randomise-then-optimise samples for a
single snapshot, and the ensemble Kalman filter (with covariance
inflation) for a drifting ionosphere.

Run:  python -m ionotomo_tpu_torch.examples.uncertainty [--outdir OUT]
          [--samples 8] [--members 8] [--device cpu] [--no-plots]

The draws (``run``'s arguments; the reference's PRNG key in brackets):
``obs_noise`` (Na, Nd) the snapshot's data noise [key 1];
``data_noise`` (S, Na·Nd) and ``prior_noise`` (S, *grid) the posterior
draws' perturbations [the two halves of key 2]; ``enkf_init`` (B, *grid),
``enkf_process`` (Nt, B, *grid) and ``enkf_obs`` (Nt, B, Na·Nd) the
ensemble filter's [key 3]. Each absent one is drawn by ``normals``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import normals, parser

NA, ND, NT = 12, 6, 5
DT_S = 60.0
WIND = (0.4, 0.0, 0.0)


def world(device):
    """The grid (20³ around 12 antennas × 6 directions), the Chapman
    background, the blob at 330 km, the prior covariance and the straight
    49-sample bundle."""
    from ..geometry import rays as rays_mod
    from ..inversion.priors import GPCovariance
    from ..models import chapman

    rng = np.random.default_rng(0)
    ants = np.concatenate([rng.uniform(-80, 80, (NA, 2)),
                           np.zeros((NA, 1))], -1)
    zen = rng.uniform(0.05, 0.45, ND)
    az = rng.uniform(0, 2 * np.pi, ND)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    grid = chapman.grid_enclosing_rays(ants, dirs, max_length_km=900.0,
                                       shape=(20, 20, 20), h_min_km=0.0,
                                       device=device)
    m_bg = chapman.log_parametrize(chapman.chapman_field(grid))
    pts = grid.meshgrid()
    blob = torch.as_tensor(0.5 * np.exp(-0.5 * np.sum(
        (pts - np.array([0.0, 0.0, 330.0])) ** 2, -1) / 70.0**2),
        dtype=torch.float32, device=device)
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=90.0,
                              kind="sqexp")
    o, d = rays_mod.make_ray_batch(
        torch.as_tensor(ants, dtype=torch.float32, device=device),
        torch.as_tensor(dirs, dtype=torch.float32, device=device))
    rb = rays_mod.sample_straight_rays(o, d, max_length_km=900.0,
                                       n_samples=49)
    return dict(grid=grid, m_bg=m_bg, blob=blob, cov=cov, rays=rb)


def run(outdir="uncertainty_out", samples=8, members=8, device=None,
        plots=True, obs_noise=None, data_noise=None, prior_noise=None,
        enkf_init=None, enkf_process=None, enkf_obs=None):
    """The reference example's workflow; returns its printed numbers: the
    share of voxels whose |posterior mean − truth| ≤ 2 std
    (``cover_fraction``) and the ensemble filter's mean spread per step
    (``enkf_spread``)."""
    from ..device import host, resolve
    from ..forward import tec as tec_mod
    from ..geometry.rays import RayBundle
    from ..inversion import solvers
    from ..inversion.kalman import ensemble_kalman_filter
    from ..models.frozen_flow import advect_periodic

    dev = resolve(device)
    os.makedirs(outdir, exist_ok=True)
    w = world(dev)
    grid, m_bg, blob, cov, rb = (w["grid"], w["m_bg"], w["blob"], w["cov"],
                                 w["rays"])
    n_rows = NA * ND

    # --- snapshot: RTO posterior samples -------------------------------
    m_true = m_bg + blob
    d_obs = tec_mod.dtec_paired(m_true, grid, rb, ND, 0)
    noise = float(np.float32(0.01 * float(d_obs.abs().max())))
    d_obs = d_obs + noise * normals(obs_noise, (NA, ND), 1, dev)
    _, mean, std = solvers.posterior_samples(
        grid, rb, d_obs, noise, m_bg, cov, num_directions=ND,
        data_noise=normals(data_noise, (samples, n_rows), 21, dev),
        prior_noise=normals(prior_noise, (samples,) + grid.shape, 22, dev),
        cg_iters=25)
    err = np.abs(host(mean) - host(m_true))
    cover_frac = float((err <= 2.0 * host(std) + 1e-6).mean())

    # --- sequence: EnKF with inflation ---------------------------------
    wind = np.array(WIND)
    d_seq = torch.stack([
        tec_mod.dtec_paired(m_bg + advect_periodic(
            blob, grid, torch.as_tensor(wind * t * DT_S, dtype=torch.float32,
                                        device=dev)), grid, rb, ND, 0)
        for t in range(NT)])
    # the time-stacked bundle, as the pipeline stacks its sequences
    rays_seq = RayBundle(points=torch.stack([rb.points] * NT),
                         ds=torch.stack([rb.ds] * NT))
    res = ensemble_kalman_filter(
        grid, rays_seq, d_seq, noise, m_bg, cov, wind, DT_S,
        num_directions=ND,
        obs_noise=normals(enkf_obs, (NT, members, n_rows), 33, dev),
        n_members=members, cg_iters=15, inflation=1.1, process_sigma=0.02,
        process_noise=normals(enkf_process, (NT, members) + grid.shape, 32,
                              dev),
        init_noise=normals(enkf_init, (members,) + grid.shape, 31, dev))
    spread = [float(s) for s in res.std_seq.mean(dim=(1, 2, 3))]

    out = dict(cover_fraction=cover_frac, enkf_spread=spread)
    if plots:
        from . import pyplot
        plt = pyplot()
        k = grid.shape[2] // 2
        fig, axes = plt.subplots(1, 3, figsize=(12, 3.6))
        for ax, (title, f) in zip(axes, [
                ("posterior mean - prior", host(mean) - host(m_bg)),
                ("posterior std", host(std)),
                ("EnKF final spread", host(res.std_seq[-1]))]):
            im = ax.imshow(f[:, :, k].T, origin="lower", cmap="viridis")
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        out["figure"] = os.path.join(outdir, "uncertainty.png")
        fig.savefig(out["figure"], dpi=110, bbox_inches="tight")
        plt.close(fig)
    return out


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--outdir", default="uncertainty_out")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--members", type=int, default=8)
    args = ap.parse_args(argv)
    r = run(args.outdir, args.samples, args.members, device=args.device,
            plots=not args.no_plots)
    print(f"RTO: {args.samples} posterior samples; |mean-truth| <= 2 std on "
          f"{100 * r['cover_fraction']:.1f}% of voxels")
    print(f"EnKF: mean spread per step: "
          f"{[round(s, 4) for s in r['enkf_spread']]}")
    if "figure" in r:
        print(f"wrote {r['figure']}")


if __name__ == "__main__":
    main()
