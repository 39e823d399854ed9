"""Ionosonde probes: the direct profile-shape observation channel.

``profile_estimation`` shows slant-TEC anchors making the single-layer
Chapman parameters observable. For a realistic MULTI-layer ionosphere
(E/F1/F2 stack) the measured identifiability from TEC-derived data alone
is ~25 km on the F2 peak height — the free voxel field absorbs part of
the height shift. The instrument that closes this is the ionosonde:
bottomside n_e(h) soundings are point log-density observations, exactly
linear in the log-field unknown (``data.ionosonde``), and they observe
the profile itself rather than any integral of it.

Workflow:
1. synthesise a multi-layer world whose F2 layer is well off the
   climatology (1.5e12 / 385 km / 70 km vs the E/F1/F2 default
   1e12 / 350 / 80) + turbulence;
2. observe it with dTEC rays, 15 slant anchors, and TWO ionosonde
   stations' bottomside soundings (``ionosonde.bottomside_probes``), and
   write them as the CLI's interchange file ``probes.npz`` in ``outdir``;
3. (a) sequentially assimilate the probes into a wrong prior
   (``anchors.assimilate_probes``), and (b) run the joint multi-layer
   (θ, δm) profile solve with probe rows.

Run: python -m ionotomo_tpu_torch.examples.ionosonde_probes [--outdir OUT]
         [--device cpu]

The draws (``run``'s arguments; the reference's PRNG key in brackets):
``white`` (28, 28, 28) the turbulence's white noise [key 4],
``data_noise`` (Na, Nd) [key 1], ``anchor_noise`` (15,) [key 2] and
``probe_noise`` (24,) the sounders' noise [key 5; absent, drawn by
``bottomside_probes`` from its seed]. The others absent are drawn by
``examples.normals``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import parser
from .profile_estimation import observed_world

SHAPE = (28, 28, 28)
F2_TRUE = (1.5e12, 385.0, 70.0)
F2_GUESS = (1.0e12, 350.0, 80.0)
#: the joint solve's prior std per parameter: E pinned (photochemical,
#: known), F1 nearly pinned, F2 free
THETA_SIGMA = (0.05, 3.0, 2.0, 0.1, 6.0, 4.0, 0.7, 50.0, 30.0)


def layers(f2, device):
    """The E/F1/F2 parameter vector with F2 = (N_peak, h_peak, H)."""
    return torch.tensor([np.log(1.2e11), 110.0, 10.0,
                         np.log(2.5e11), 180.0, 40.0,
                         np.log(f2[0]), f2[1], f2[2]],
                        dtype=torch.float32, device=device)


def run(outdir="ionosonde_out", device=None, plots=True, white=None,
        data_noise=None, anchor_noise=None, probe_noise=None, cg_iters=40):
    """The reference example's workflow; returns its printed numbers: the
    probe rows and their altitude range, the log-profile rms of the
    climatological prior and after probe assimilation, the joint solve's
    F2 (``n_peak``, ``h_peak_km``, ``scale_km``) and its log-profile rms.
    ``cg_iters``: the joint solve's CG depth (the reference's 40);
    ``plots``: this example draws none."""
    from ..data.ionosonde import bottomside_probes, probes_to_npz
    from ..device import host, resolve
    from ..inversion import anchors as anch
    from ..inversion.priors import GPCovariance
    from ..inversion.profile import (log_profile_rms,
                                     map_gauss_newton_profile,
                                     multi_chapman_log_field)

    dev = resolve(device)
    os.makedirs(outdir, exist_ok=True)
    # --- multi-layer world: F2 well off the climatology ---------------
    t_true = layers(F2_TRUE, dev)
    w = observed_world(dev, SHAPE, np.random.default_rng(0), white,
                       data_noise, anchor_noise,
                       lambda g: multi_chapman_log_field(g, t_true))
    grid, m_true = w["grid"], w["m_true"]

    probes = bottomside_probes(m_true, grid,
                               [[-25.0, 15.0], [20.0, -20.0]],
                               n_per_station=12, noise_log=0.05, seed=5,
                               noise=probe_noise)
    z = probes.points[:, 2]
    out = dict(probe_rows=int(probes.values.shape[0]),
               probe_z_min=float(z.min()), probe_z_max=float(z.max()),
               npz=os.path.join(outdir, "probes.npz"))
    probes_to_npz(out["npz"], probes)      # the CLI interchange file

    # --- (a) sequential assimilation into a wrong prior mean ----------
    t0 = layers(F2_GUESS, dev)
    m_prior = multi_chapman_log_field(grid, t0)
    m_upd = anch.assimilate_probes(grid, m_prior, probes)
    out["rms_prior"] = float(log_profile_rms(m_prior, m_true, grid))
    out["rms_assimilated"] = float(log_profile_rms(m_upd, m_true, grid))

    # --- (b) joint multi-layer profile solve with probe rows ----------
    cov = GPCovariance.create(grid, sigma=0.3, length_scale=80.0,
                              kind="exponential")
    res = map_gauss_newton_profile(
        grid, w["rays"], w["d"], w["noise_d"], t0, THETA_SIGMA, cov,
        num_directions=w["nd"], anchors=w["anchors"], gn_iters=8,
        cg_iters=cg_iters,
        field_builder=(lambda t: multi_chapman_log_field(grid, t)),
        probes=probes)
    t_est = host(res.theta)
    out.update(n_peak=float(np.exp(t_est[6])), h_peak_km=float(t_est[7]),
               scale_km=float(t_est[8]),
               rms_joint=float(log_profile_rms(res.m, m_true, grid)))
    return out


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--outdir", default="ionosonde_out")
    args = ap.parse_args(argv)
    r = run(args.outdir, device=args.device, plots=not args.no_plots)
    print(f"{r['probe_rows']} probe rows from 2 sounder stations "
          f"(bottomside, z {r['probe_z_min']:.0f}–{r['probe_z_max']:.0f} km)")
    print("\nhorizontally-averaged log-profile rms vs truth:")
    print(f"  climatological prior:             {r['rms_prior']:.3f}")
    print(f"  after probe assimilation:         {r['rms_assimilated']:.3f}")
    print("\nF2 layer:            N_peak        h_peak     H")
    print(f"  truth:          {F2_TRUE[0]:10.3e}   {F2_TRUE[1]:6.1f}  "
          f"{F2_TRUE[2]:5.1f}")
    print(f"  guess:          {F2_GUESS[0]:10.3e}   {F2_GUESS[1]:6.1f}  "
          f"{F2_GUESS[2]:5.1f}")
    print(f"  estimated:      {r['n_peak']:10.3e}   {r['h_peak_km']:6.1f}  "
          f"{r['scale_km']:5.1f}")
    print(f"\njoint-solve log-profile rms:        {r['rms_joint']:.3f}")
    print("(without probe rows the measured F2 h_peak identifiability "
          "is ~25 km; with two stations it is ~1 km)")


if __name__ == "__main__":
    main()
