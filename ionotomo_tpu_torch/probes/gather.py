"""The vector-gather probe (port of ``bench/probe_gather.py``): one JSON
line.

The JAX package's probe asks whether a Pallas TPU kernel can gather
``out[i, j] = table[idx[i, j], j]`` from a (16384, 128) f32 table (Mosaic
could not, beyond one (8, 128) vreg). On the H100 the gather is kernel KG
(``kernels/csrc/vector_gather.cu``); the probe checks it bitwise against
``torch.gather`` at the table size and at the one-vreg control size, and
times both with CUDA events:

    python -m ionotomo_tpu_torch.probes.gather

It needs a CUDA device and fails without one. ``rowgather_baseline`` is
the reference probe's baseline beside it: chained tricubic value + gradient
evaluations (kernel K5), the tracer's access pattern, in million point
evaluations per second.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..core import tricubic
from ..core.grids import Grid3D
from ..device import resolve
from ..models import chapman


def vector_gather_ref(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of KG: ``torch.gather`` along the rows."""
    return torch.gather(table, 0, idx.long())


def vector_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = table[idx[i, j], j]: kernel KG on CUDA, the plain
    version on the CPU. table (R, W) f32, idx (M, W) int32."""
    if table.is_cuda:
        return kernels.vector_gather(table, idx)
    return vector_gather_ref(table, idx)


def probe_inputs(rows: int, width: int, device=None):
    """The JAX probe's inputs: a normal (rows, width) f32 table and
    uniform int32 row indices of the same shape, from seed 0, on
    ``device`` (the card by default)."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    idx = rng.integers(0, rows, (rows, width)).astype(np.int32)
    device = resolve(device)
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(idx).to(device))


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probe(device, rows: int = 16384, width: int = 128,
          reps: int = 50) -> dict:
    """KG against ``torch.gather`` on a CUDA device: bitwise agreement,
    max abs error, and the mean ms of each over ``reps`` calls."""
    if torch.device(device).type != "cuda":
        raise RuntimeError(f"the gather probe needs a CUDA device, got "
                           f"{device}")
    table, idx = probe_inputs(rows, width, device)
    got = vector_gather(table, idx)
    want = vector_gather_ref(table, idx)
    torch.cuda.synchronize()
    return {
        "rows": rows, "width": width,
        "bitwise_equal": bool(torch.equal(got, want)),
        "max_abs_err": float((got - want).abs().max()),
        "ms": _cuda_ms(lambda: vector_gather(table, idx), reps),
        "plain_ms": _cuda_ms(lambda: vector_gather_ref(table, idx), reps),
    }


def rowgather_chain(f2d: torch.Tensor, grid: Grid3D, pts: torch.Tensor,
                    n_steps: int) -> torch.Tensor:
    """``n_steps`` chained value + gradient evaluations through the
    tricubic row gather, each moving the points half a kilometre along
    the normalised gradient: the tracer's dependent access pattern."""
    for _ in range(n_steps):
        v, g = tricubic.interp_rows_with_grad(f2d, grid, pts)
        gn = g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-12)
        pts = pts + 0.5 * gn + 1e-6 * v[:, None]
    return pts


def rowgather_baseline(nx: int = 128, n_pts: int = 1 << 17,
                       n_steps: int = 64, device=None) -> float:
    """Million point evaluations per second of ``rowgather_chain`` on an
    nx³ Chapman grid (one untimed run first)."""
    device = resolve(device)
    grid = Grid3D.from_bounds((-400.0, -400.0, 0.0), (400.0, 400.0, 1100.0),
                              (nx, nx, nx), device=device)
    m = chapman.log_parametrize(chapman.chapman_field(grid))
    f2d = m.reshape(nx * nx, nx).contiguous()
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(np.stack(
        [rng.uniform(-300, 300, n_pts), rng.uniform(-300, 300, n_pts),
         rng.uniform(100, 900, n_pts)], -1).astype(np.float32)).to(device)

    def timed():
        t0 = time.perf_counter()
        rowgather_chain(f2d, grid, pts, n_steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    timed()
    return n_pts * n_steps / timed() / 1e6


def run(device) -> dict:
    """The probe's JSON record on a CUDA device: the (16384, 128) table
    and the (8, 128) one-vreg control."""
    control = probe(device, rows=8)
    full = probe(device)
    return {
        "metric": "vector_gather_probe",
        "vector_gather_supported": full["bitwise_equal"],
        "one_vreg_control_ok": control["bitwise_equal"],
        "kernel_ms": full["ms"], "plain_ms": full["plain_ms"],
        "control_kernel_ms": control["ms"],
        "control_plain_ms": control["plain_ms"],
        "max_abs_err": max(full["max_abs_err"], control["max_abs_err"]),
        "device": torch.cuda.get_device_name(device),
        "torch_version": torch.__version__,
        "rowgather_baseline_Mpt_evals_per_sec": rowgather_baseline(
            device=device),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("gather probe: torch.cuda.is_available() is False; it needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    rec = run(torch.device("cuda", 0))
    print(json.dumps(rec))
    return 0 if rec["vector_gather_supported"] else 1


if __name__ == "__main__":
    sys.exit(main())
