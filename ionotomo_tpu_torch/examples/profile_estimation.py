"""Profile estimation: recover the Chapman (N_peak, h_peak, H) from data.

dTEC is measurably blind to the horizontally-uniform vertical profile,
and vertical-column VTEC anchors pin only the column integral, not its
shape. Multi-elevation **slant** absolute-TEC observations weight
altitudes differently per elevation, so solving the Chapman parameters
θ = (N_peak, h_peak, H) jointly with the voxel field
(``inversion.profile.map_gauss_newton_profile``) recovers the vertical
shape — here from a truth profile deliberately far off the prior guess.

Workflow:
1. synthesise a "wrong-profile" world (N_peak 1.6×, h_peak +30 km,
   H −10 km off the climatological guess) + turbulence;
2. observe it with dTEC rays and 15 slant TEC anchors (3 receivers ×
   5 elevations, ``anchors.slant_bundle``);
3. run the joint (θ, δm) MAP solve and compare the recovered profile
   against (a) the prior and (b) the fixed-profile anchored solve.

Run: python -m ionotomo_tpu_torch.examples.profile_estimation [--device cpu]

The draws (``run``'s arguments; the reference's PRNG key in brackets):
``white`` (32, 32, 32) the turbulence's white noise [key 4],
``data_noise`` (Na, Nd) [key 1] and ``anchor_noise`` (15,) [key 2]. Each
absent one is drawn by ``examples.normals``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import normals, parser

SHAPE = (32, 32, 32)
THETA_TRUE = (1.6e12, 380.0, 70.0)
THETA_GUESS = (1.0e12, 350.0, 80.0)


def observed_world(device, shape, rng, white, data_noise, anchor_noise,
                   field_of):
    """What this example and ``ionosonde_probes`` share: 8 antennas × 5
    directions, the grid enclosing them, the truth ``field_of(grid)`` +
    turbulence (amplitude 0.1, outer scale 120 km), the 65-sample dTEC
    bundle with 1 % noise, and 15 slant anchors (3 receivers × 5
    elevations) with 0.5 % noise. ``rng`` is the reference's numpy
    generator, drawn in its order."""
    from ..forward import tec as tec_mod
    from ..geometry import rays as rays_mod
    from ..inversion import anchors as anch
    from ..models import chapman
    from ..models.turbulence import turbulent_log_perturbation

    ants = np.concatenate([rng.uniform(-40, 40, (8, 2)),
                           np.zeros((8, 1))], -1)
    zen = rng.uniform(0.05, 0.45, 5)
    az = rng.uniform(0, 2 * np.pi, 5)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1)
    grid = chapman.grid_enclosing_rays(ants, dirs, shape=shape, h_min_km=0.0,
                                       device=device)
    m_true = field_of(grid) + turbulent_log_perturbation(
        grid, normals(white, shape, 4, device), amplitude=0.1,
        outer_scale_km=120.0)

    nd = dirs.shape[0]
    origins, dvecs = rays_mod.make_ray_batch(
        torch.as_tensor(ants, dtype=torch.float32, device=device),
        torch.as_tensor(dirs, dtype=torch.float32, device=device))
    rb = rays_mod.sample_straight_rays(origins, dvecs, n_samples=65)
    d = tec_mod.dtec_paired(m_true, grid, rb, nd, 0)
    noise_d = 0.01 * float(torch.std(d, correction=0)) + 1e-3
    d = d + noise_d * normals(data_noise, tuple(d.shape), 1, device)

    rec = np.array([[-25.0, -15.0], [5.0, 25.0], [20.0, -20.0]])
    els = np.deg2rad([15.0, 25.0, 40.0, 60.0, 75.0])
    xy = np.repeat(rec, len(els), axis=0)
    el = np.tile(els, len(rec))
    azs = rng.uniform(0, 2 * np.pi, xy.shape[0])
    bundle = anch.slant_bundle(grid, xy, azs, el, n_samples=65)
    v = tec_mod.tec(m_true, grid, bundle)
    noise_a = 0.005 * float(torch.mean(v))
    anchors = anch.TecAnchors(
        rays=bundle,
        values=v + noise_a * normals(anchor_noise, tuple(v.shape), 2, device),
        noise_std=torch.tensor(noise_a, dtype=torch.float32, device=device))
    return dict(grid=grid, m_true=m_true, rays=rb, d=d, noise_d=noise_d,
                nd=nd, anchors=anchors, rng=rng)


def run(device=None, plots=True, white=None, data_noise=None,
        anchor_noise=None, cg_iters=40):
    """The reference example's workflow; returns its printed numbers: the
    estimated θ (``n_peak``, ``h_peak_km``, ``scale_km``) and the
    horizontally averaged log-profile rms of the prior, the
    fixed-profile anchored solve and the parametric solve. ``cg_iters``:
    the joint solve's CG depth (the reference's 40); ``plots``: this
    example draws none."""
    from ..device import resolve
    from ..inversion import anchors as anch
    from ..inversion.priors import GPCovariance
    from ..inversion.profile import (ProfileParams, chapman_log_field,
                                     log_profile_rms,
                                     map_gauss_newton_profile)
    from ..inversion.solvers import map_gauss_newton

    dev = resolve(device)
    # --- world: truth profile far off the climatological guess --------
    theta_true = ProfileParams.create(*THETA_TRUE, device=dev)
    w = observed_world(dev, SHAPE, np.random.default_rng(0), white,
                       data_noise, anchor_noise,
                       lambda g: chapman_log_field(g, theta_true))
    grid, rb, d, noise_d, nd = (w["grid"], w["rays"], w["d"], w["noise_d"],
                                w["nd"])

    # --- joint (θ, δm) MAP solve --------------------------------------
    theta0 = ProfileParams.create(device=dev)        # the (wrong) guess
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="von_karman")
    res = map_gauss_newton_profile(
        grid, rb, d, noise_d, theta0, (0.7, 50.0, 30.0), cov,
        num_directions=nd, anchors=w["anchors"], gn_iters=6,
        cg_iters=cg_iters)

    # --- the shape metric dTEC alone cannot move ----------------------
    m_prior = chapman_log_field(grid, theta0)
    m_anch = anch.assimilate_anchors(grid, m_prior,
                                     anch.background_covariance(grid),
                                     w["anchors"])
    res_fixed = map_gauss_newton(grid, rb, d, noise_d, m_anch, cov,
                                 num_directions=nd, gn_iters=2,
                                 cg_iters=40)
    m_true = w["m_true"]
    return dict(n_peak=float(res.theta.n_peak),
                h_peak_km=float(res.theta.h_peak_km),
                scale_km=float(res.theta.scale_km),
                rms_prior=float(log_profile_rms(m_prior, m_true, grid)),
                rms_fixed=float(log_profile_rms(res_fixed.m, m_true, grid)),
                rms_parametric=float(log_profile_rms(res.m, m_true, grid)))


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    r = run(device=args.device, plots=not args.no_plots)
    print("Chapman profile:         N_peak        h_peak     H")
    print(f"  truth:              {THETA_TRUE[0]:10.3e}   "
          f"{THETA_TRUE[1]:6.1f}  {THETA_TRUE[2]:5.1f}")
    print(f"  prior guess:        {THETA_GUESS[0]:10.3e}   "
          f"{THETA_GUESS[1]:6.1f}  {THETA_GUESS[2]:5.1f}")
    print(f"  estimated:          {r['n_peak']:10.3e}   "
          f"{r['h_peak_km']:6.1f}  {r['scale_km']:5.1f}")
    print("\nhorizontally-averaged log-profile rms vs truth:")
    print(f"  prior profile:                    {r['rms_prior']:.3f}")
    print(f"  fixed-profile anchored solve:     {r['rms_fixed']:.3f}"
          "   <- anchors pin the column, not the shape")
    print(f"  parametric profile solve:         {r['rms_parametric']:.3f}")


if __name__ == "__main__":
    main()
