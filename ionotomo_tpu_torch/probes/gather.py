"""The vector-gather probe (port of ``bench/probe_gather.py``): one JSON
line.

The JAX package's probe asks whether a Pallas TPU kernel can gather
``out[i, j] = table[idx[i, j], j]`` from a (16384, 128) f32 table (Mosaic
could not, beyond one (8, 128) vreg). On the H100 the gather is kernel KG
(``kernels/csrc/vector_gather.cu``); the probe checks it bitwise against
``torch.gather`` at the table size and at the one-vreg control size, and
times both with CUDA events:

    python -m ionotomo_tpu_torch.probes.gather

It needs a CUDA device and fails without one. Not ported yet: the
row-gather baseline ``rowgather_baseline``, which runs the cubic
value-and-gradient evaluator (ROADMAP.md Queue 2, K5).
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import kernels
from ..device import resolve


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
        "rowgather_baseline": "not ported (needs the cubic evaluator, K5)",
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
