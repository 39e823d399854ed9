"""Real-data workflow: h5parm in → anchored, curved-Earth inversion → products.

The path a LOFAR user takes:

1. solutions arrive as a losoto **h5parm** (tec/phase soltabs) →
   ``DataPack.from_h5parm``;
2. the a-priori ionosphere is evaluated with **curved-Earth** geometry
   (true altitudes + solar terminator across the wide grid);
3. an external GNSS **VTEC map** is assimilated as absolute-TEC anchors
   (sequential DA through the long-horizontal background covariance) —
   fixing the common-mode/profile component dTEC cannot observe;
4. the MAP inversion runs, and science products come out (VTEC map of
   the reconstruction, dTEC predictions onto any geometry).

Self-contained: synthesizes its own "observed" h5parm and VTEC values.
Run: python -m ionotomo_tpu_torch.examples.real_data_workflow
         [--workdir DIR] [--in-memory] [--device cpu]

``--in-memory`` (``run(h5parm=False)``) hands the DataPack that the h5parm
round trip would give to the pipeline without writing the file, for a
machine without h5py: the values referenced to antenna 0, the noise
0.01 TECU, the reader's frequency and frame model.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import parser

NOISE_TECU = 0.01


def as_read_back(dp):
    """The DataPack ``DataPack.from_h5parm(path, noise_tecu=NOISE_TECU)``
    reads from ``dp.to_h5parm(path)``, made in memory
    (``data.h5parm.load_h5parm``'s tec branch)."""
    from .. import constants
    from ..data.datapack import DataPack

    dtec = dp.dtec - dp.dtec[:1]
    return DataPack(dp.array, dp.directions, dp.times, dtec=dtec,
                    flags=np.zeros(dtec.shape, bool),
                    noise_std=NOISE_TECU * constants.TECU
                    / constants.TEC_SCALE,
                    ref_antenna=0,
                    frequency_hz=constants.DEFAULT_FREQUENCY_HZ,
                    frame_model="iau2006")


def run(workdir="real_data_out", device=None, plots=True, white=None,
        h5parm=True):
    """The reference example's workflow; returns its printed numbers: the
    DataPack's shape, the VTEC map's shape and mean (working units), and
    the mean relative absolute-VTEC error at the anchor columns
    (``anchor_error``). ``white``: the truth's turbulence white noise,
    (28, 28, 28) standard normals; ``plots``: this example draws none."""
    from ..config import (EngineConfig, GridConfig, PhysicsConfig,
                          PriorConfig, RayConfig, RuntimeConfig,
                          SolverConfig)
    from ..data.datapack import DataPack
    from ..data.synth import generate_example_datapack
    from ..device import resolve
    from ..forward import tec as tec_mod
    from ..inversion import anchors as anch
    from ..inversion.pipeline import InversionPipeline

    dev = resolve(device)
    os.makedirs(workdir, exist_ok=True)

    # --- 1. "observed" solutions as an h5parm ---------------------------
    dp0, truth = generate_example_datapack(
        n_antennas=14, n_directions=8, n_times=1, grid_shape=(28, 28, 28),
        curved_earth=True, noise_tecu=NOISE_TECU, turbulence_amp=0.3,
        white=white, device=dev)
    if h5parm:
        path = os.path.join(workdir, "solutions.h5")
        dp0.to_h5parm(path)
        dp = DataPack.from_h5parm(path, noise_tecu=NOISE_TECU)
    else:
        dp = as_read_back(dp0)

    # --- 2. curved-Earth pipeline ---------------------------------------
    cfg = EngineConfig(
        physics=PhysicsConfig(curved_earth=True),
        grid=GridConfig(shape=(28, 28, 28)),
        rays=RayConfig(n_samples=33),
        prior=PriorConfig(kind="von_karman", sigma=0.3,
                          length_scale_km=80.0),
        solver=SolverConfig(solver="map_gauss_newton", gn_iters=2,
                            cg_iters=10),
        runtime=RuntimeConfig(
            checkpoint_dir=os.path.join(workdir, "ckpt"),
            metrics_path=os.path.join(workdir, "metrics.jsonl")),
    )
    pipe = InversionPipeline(dp, cfg, device=dev)

    # --- 3. external VTEC map as absolute-TEC anchors -------------------
    # (here synthesized from the truth field; in reality: a GNSS product)
    bundle = anch.vertical_anchor_bundle(pipe.grid, nx=3, ny=3)
    m_true = torch.as_tensor(truth["m"][0], device=dev)
    v_obs = tec_mod.tec(m_true, truth["grid"], bundle)
    anchors = anch.TecAnchors(
        rays=bundle, values=v_obs,
        noise_std=torch.tensor(0.01 * float(v_obs.mean()),
                               dtype=torch.float32, device=dev))
    sol = pipe.run(resume=False, anchors=anchors)

    # --- 4. science products --------------------------------------------
    m = torch.as_tensor(sol.m[0], device=dev)
    if not bool(torch.isfinite(m).all()):
        raise FloatingPointError("the reconstruction is not finite")
    vtec = tec_mod.vtec_map(m, pipe.grid)
    v_rec = tec_mod.tec(m, pipe.grid, bundle)
    return dict(datapack_shape=tuple(dp.shape),
                vtec_shape=tuple(vtec.shape), vtec_mean=float(vtec.mean()),
                anchor_error=float(torch.mean((v_rec - v_obs).abs()
                                              / v_obs)),
                workdir=workdir)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--workdir", default="real_data_out")
    ap.add_argument("--in-memory", action="store_true",
                    help="skip the h5parm file (no h5py needed)")
    args = ap.parse_args(argv)
    r = run(args.workdir, device=args.device, plots=not args.no_plots,
            h5parm=not args.in_memory)
    how = "in memory" if args.in_memory else "h5parm ingested"
    print(f"{how}: {r['datapack_shape']} (antennas, times, directions)")
    print(f"reconstruction VTEC map: {r['vtec_shape']}, mean "
          f"{r['vtec_mean']:.0f} working units "
          f"({r['vtec_mean'] / 1000.0:.1f} TECU)")
    print(f"absolute-VTEC error at the anchor columns: "
          f"{100 * r['anchor_error']:.1f}% (unanchored runs of this world "
          f"leave ~10%; dTEC alone cannot pin the absolute level)")
    print("workflow complete; artifacts in", args.workdir)


if __name__ == "__main__":
    main()
