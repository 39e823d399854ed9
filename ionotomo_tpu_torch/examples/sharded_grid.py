"""Demo: tomography on a spatially-sharded grid (the >HBM growth path).

The field is sharded along x over a device mesh (a 2-plane halo exchange
between neighbours); bent rays trace through it and a damped
least-squares TEC inversion runs end-to-end on the sharded field: the
sharded operator (``parallel.grid_sharding.ShardedGridDtecLinear``)
gives J and its exact transpose, so the stock LSQR needs no change.

Run:  python -m ionotomo_tpu_torch.examples.sharded_grid [--shards S]
          [--device cpu]

``--shards S``: a mesh that repeats the device S times (S shards in turn
on one device: arithmetic, not a multi-device speed); by default every
visible card on the card, one shard on any other device. The grid's x
size follows the shard count, 8·max(2, S // 2).
"""
from __future__ import annotations

import numpy as np
import torch

from . import parser

N_RAYS = 48
FREQ_HZ = 60e6
LENGTH_KM = 900.0


def run(shards=None, device=None, plots=True, meshless=False):
    """The reference example's workflow; returns its printed numbers: the
    shard count, the bent trace's mean TEC, the LSQR's residual before and
    after and its iterations. ``meshless=True`` runs the same grid and
    rays (the x size of ``shards`` shards) through the unsharded tracer
    and operator: what the sharded run is held to. ``plots``: this
    example draws none."""
    from ..core import linalg
    from ..core.grids import Grid3D
    from ..device import resolve
    from ..forward import tec as tec_mod
    from ..geometry import fermat, rays as rays_mod
    from ..models import chapman
    from ..parallel import grid_sharding as gs

    dev = resolve(device)
    if shards is None:
        shards = torch.cuda.device_count() if dev.type == "cuda" else 1
        devices = None if dev.type == "cuda" else [dev]
    else:
        devices = [dev] * shards
    grid = Grid3D.from_bounds((-300, -300, 0.0), (300, 300, 1000.0),
                              (8 * max(2, shards // 2), 24, 24), device=dev)
    m_prior = chapman.log_parametrize(chapman.chapman_field(grid))

    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(-40, 40, (N_RAYS, 2)),
                        np.zeros((N_RAYS, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.1, 0.5, N_RAYS)
    az = rng.uniform(0, 2 * np.pi, N_RAYS)
    d = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                  np.cos(zen)], -1).astype(np.float32)
    o = torch.as_tensor(o, device=dev)
    d = torch.as_tensor(d, device=dev)
    rb = rays_mod.sample_straight_rays(o, d, max_length_km=LENGTH_KM,
                                       n_samples=33)

    if meshless:
        _, tec = fermat.trace_rays(m_prior, grid, o, d, FREQ_HZ, LENGTH_KM,
                                   n_steps=32, method="leapfrog")
        op = tec_mod.tec_linear_op(m_prior, grid, rb, "simpson", "cubic")
        d_obs = tec_mod.tec(m_prior, grid, rb) * 1.02

        def fit_of(dm):
            return tec_mod.tec(m_prior + dm, grid, rb)
    else:
        mesh = gs.grid_mesh(devices)
        f_sh = gs.shard_field(mesh, m_prior)
        # 1) bent-ray trace through the sharded field
        _, tec = gs.trace_rays_sharded(mesh, f_sh, grid, o, d, FREQ_HZ,
                                       LENGTH_KM, n_steps=32)
        # 2) TEC inversion on the sharded field (2 % excess to recover)
        geo = gs.ShardedGridGeometry(mesh, grid, rb, None, None, "simpson")
        op = gs.ShardedGridDtecLinear(mesh, f_sh, grid, rb, None,
                                      geometry=geo)
        d_obs = gs.tec_sharded(mesh, f_sh, grid, rb, geometry=geo) * 1.02

        def fit_of(dm):
            return gs.tec_sharded(mesh, gs.shard_field(mesh, m_prior + dm),
                                  grid, rb, geometry=geo)
    g0 = op.g0
    dm, info = linalg.lsqr(op.apply, op.apply_t, d_obs - g0,
                           torch.zeros_like(m_prior), damp=1e-3,
                           max_iters=25)
    fit = fit_of(dm)
    return dict(shards=shards, meshless=meshless,
                tec_mean=float(tec.mean()),
                residual_before=float(torch.linalg.norm(d_obs - g0)),
                residual_after=float(torch.linalg.norm(d_obs - fit)),
                iterations=int(info.iterations), dm=dm)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of a mesh that repeats the device")
    args = ap.parse_args(argv)
    r = run(args.shards, device=args.device, plots=not args.no_plots)
    print(f"{r['shards']} shard(s); field sharded over all of them")
    print(f"bent trace through sharded field: TEC mean "
          f"{r['tec_mean']:.1f} working units")
    print(f"sharded LSQR: residual {r['residual_before']:.2f} -> "
          f"{r['residual_after']:.2f} ({r['iterations']} masked-convergence "
          f"iters)")
    print(f"update field: whole on {r['dm'].device}, sharded on entry to "
          f"every application of J")


if __name__ == "__main__":
    main()
