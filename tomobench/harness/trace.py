"""The traced sub-window: ``torch.profiler`` over a fixed number of steady
units, its Chrome trace read back for the device's busy intervals, the
device operations by time, the idle gaps by the benchmark's own span the
host was in, and the hand-written kernels' launches.

The sub-window runs from the start of the first unit's span to the end of
the last one's (each unit ends in a synchronise, so its device work lies
inside). Busy is the union of every kernel, copy and fill inside it.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNIT_SPAN = "tomobench.unit"
SPAN_PREFIX = "tomobench."


def handwritten_names(csrc: Path) -> frozenset:
    """The ``__global__`` functions of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    names = set()
    for f in sorted(csrc.glob("*.cu*")):
        names.update(pat.findall(f.read_text()))
    return frozenset(names)


def base_name(kernel: str) -> str:
    """A kernel record's function name without namespaces, template
    arguments or parameters."""
    kernel = kernel.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", kernel.replace("void ", "", 1), maxsplit=1)[0]
    return head.strip().split("::")[-1].split(" ")[-1]


def short_name(kernel: str) -> str:
    """A record's name up to its parameter list, at most 160 characters."""
    depth, out = 0, []
    for ch in kernel.replace("(anonymous namespace)::", ""):
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:160]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Summary:
    """What the readers of per-layer metrics read from one traced
    sub-window."""

    def __init__(self, events, n_units: int, handwritten: frozenset,
                 counted_launches: int):
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(SPAN_PREFIX)]
        units = [e for e in spans if e["name"] == UNIT_SPAN]
        if len(units) != n_units:
            raise RuntimeError(f"the trace holds {len(units)} unit spans, "
                               f"{n_units} units ran")
        t0 = min(e["ts"] for e in units)
        t1 = max(e["ts"] + e["dur"] for e in units)
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS
               and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1]
        self.n_units = n_units
        self.window_s = (t1 - t0) * 1e-6
        busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self.launches = len(dev)
        self.kernels = [e for e in dev if e["cat"] == "kernel"]
        self.handwritten = sum(base_name(e["name"]) in handwritten
                               for e in self.kernels)
        self.counted_launches = counted_launches
        by_name = {}
        for e in dev:
            key = short_name(e["name"])
            by_name[key] = by_name.get(key, 0.0) + e["dur"] * 1e-6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        inner = [e for e in spans if e["name"] != UNIT_SPAN] or spans
        gaps = []
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                gaps.append((self._span_at(inner, s, units), (e - s) * 1e-6))
        self.idle_gaps = sorted(gaps, key=lambda g: -g[1])
        self.work_s = None      # the units' least time, set by the harness

    @staticmethod
    def _span_at(inner, t, units):
        best = None
        for e in inner:
            if e["ts"] <= t < e["ts"] + e["dur"]:
                if best is None or e["ts"] >= best["ts"]:
                    best = e
        if best is not None:
            return best["name"]
        return "between units" if not any(
            u["ts"] <= t < u["ts"] + u["dur"] for u in units) else UNIT_SPAN

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def profile(run_unit, first: int, n_units: int, out_dir: Path,
            launches_now) -> Summary:
    """Run units first .. first+n_units−1 under the profiler, each in a
    ``tomobench.unit`` span; read the trace back."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    torch.cuda.synchronize()
    before = launches_now()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + n_units):
            with record_function(UNIT_SPAN):
                run_unit(i)
        torch.cuda.synchronize()
    counted = launches_now() - before
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    from ionotomo_tpu_torch import kernels
    csrc = Path(kernels.__file__).resolve().parent / "csrc"
    return Summary(events, n_units, handwritten_names(csrc), counted)
