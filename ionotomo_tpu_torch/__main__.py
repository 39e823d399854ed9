"""Command-line interface of the port: the streaming service.

  python -m ionotomo_tpu_torch serve IN_DIR OUT_DIR [--solver enkf] ...
      [--device cpu]

The ``serve`` subcommand of the reference's CLI (``ionotomo_tpu serve``),
with its arguments and defaults, and ``--device`` (the card unless named).
The reference's other subcommands (``simulate``, ``invert``, ``predict``,
``info``) are not ported yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import argparse
import sys


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
    v.add_argument("--device", default=None,
                   help="torch device of the service (default: the card, "
                        "cuda; 'cpu' runs the plain PyTorch versions)")
    v.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
