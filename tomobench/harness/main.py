"""One run of one cell: set-up, the measured window, the traced sub-window
(``--trace 1``), the check against the plain reference, the last line.

Everything that belongs to one configuration, traffic mix, driver or
metric is found by name: ``configs/<config>.json``, ``traffic/<mix>.json``
(its ``driver`` names ``drivers/<driver>.py``), ``limits/<cell>.json``,
and for each metric ``metrics/<name>.py`` or, failing that, the reader of
its quantity ``metrics/<name before the first dot>.py``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "tomobench"
FORBIDDEN = ("jax", "jaxlib", "flax", "ionotomo_tpu", "bench")
#: Blocks of ``profile_units`` units profiled at most until one holds every
#: launch of the program's own kernels.
PROFILE_ATTEMPTS = 3
#: The card a run measures (the CPU tests put "cpu" here to drive the rest
#: of a run on the plain versions).
DEVICE = ("cuda", 0)


class Failure(Exception):
    """A run that must print no result: the message goes to stderr."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def _json(path: Path) -> dict:
    if not path.is_file():
        raise Failure(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def spec_of(workload: str) -> dict:
    """The cell's entries of BENCHMARK.json and its data files, by name."""
    bench = _json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise Failure(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mix = _json(BENCH / "traffic" / f"{cell['traffic']}.json")

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {"cell": cell, "config": _json(ROOT / conf["file"]),
            "mix": mix, "limits": _json(BENCH / "limits" / f"{workload}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)],
            "run_seconds": bench["run_seconds"]}


def reader(name: str):
    """The module that reads metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            mod_name = "tomobench_metric_" + stem.replace(".", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise Failure(f"no reader for metric {name!r} under tomobench/metrics")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Window:
    """The measured window: units run back to back until ``seconds`` have
    passed since the first began; each unit's latency on the host clock
    (its last act is a synchronise)."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.latencies = []
        self.span = 0.0

    def run(self, unit) -> int:
        t0 = time.perf_counter()
        i = 0
        while True:
            s = time.perf_counter()
            unit(i)
            e = time.perf_counter()
            self.latencies.append(e - s)
            i += 1
            if e - t0 >= self.seconds:
                break
        self.span = e - t0
        return i


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv, t_start: float) -> int:
    args = parse(argv)
    spec = spec_of(args.workload)
    import torch
    if not torch.cuda.is_available():
        raise Failure("torch.cuda.is_available() is False: the benchmark "
                      "runs on the card only", 3)
    chips = int(spec["cell"]["chips"])
    if torch.cuda.device_count() < chips:
        raise Failure(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} found", 3)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    dev = torch.device(*DEVICE)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    import ionotomo_tpu_torch  # noqa: F401  (turns TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from ionotomo_tpu_torch import kernels

    mix = spec["mix"]
    driver = importlib.import_module(f"tomobench.drivers.{mix['driver']}")
    cell = driver.Cell(spec["config"], mix, args.seed, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    torch.cuda.reset_peak_memory_stats(dev)

    window = Window(args.seconds)
    n = window.run(cell.unit)
    half = window.latencies[:n // 2], window.latencies[n // 2:]
    print(f"window: {n} units in {window.span!r} s; mean latency of the "
          f"first and second half {[sum(h) / max(len(h), 1) for h in half]}",
          file=sys.stderr)
    summary = None
    if args.trace or any(m["source"] == "device_trace"
                         for m in spec["end_to_end"]):
        summary = _traced(cell, n, mix, kernels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)

    bad_modules = forbidden_modules()
    if bad_modules:
        raise Failure(f"forbidden modules loaded: {bad_modules}", 6)

    numbers, failed = cell.check(spec["limits"])
    correct = failed == 0 and all(v <= lim for _, v, lim in numbers)
    for name, v, lim in numbers:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)

    metrics = {}
    if args.trace:
        wanted = spec["per_layer"]
    else:
        wanted = spec["end_to_end"]
    ctx = {"window": window, "units": n, "cell": cell, "setup_s": setup_s,
           "summary": summary}
    for m in wanted:
        value = reader(m["name"]).read(m["name"], ctx)
        if value is None:
            raise Failure(f"metric {m['name']} read nothing in "
                          f"{args.workload}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": int(n * cell.per_unit["attempted"]),
           "failed": int(failed), "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in numbers}
    bad_modules = forbidden_modules()
    if bad_modules:
        raise Failure(f"forbidden modules loaded: {bad_modules}", 6)
    print(json.dumps(out))
    return 0


def _traced(cell, n, mix, kernels):
    """Profile the mix's ``profile_units`` steady units after the window,
    and hold the profiler's hand-written launches to the program's own
    launch counters over them. A traced run reads its per-layer metrics
    from them; an untraced one its end-to-end metrics taken from the
    device trace, once the window has closed. The profiler now and then
    drops a few records of a long trace (2 of 740 launches in one c4 run
    on the card): such a block is read by nothing, and the next
    ``profile_units`` units are profiled in its place, up to
    ``PROFILE_ATTEMPTS`` blocks."""
    from . import trace
    k = int(mix["profile_units"])
    for first in range(n, n + PROFILE_ATTEMPTS * k, k):
        summary = trace.profile(cell.unit, first, k, BENCH / ".out",
                                lambda: sum(kernels.launches.values()))
        lost = (f"the profiler saw {summary.handwritten} launches of the "
                f"program's kernels over {k} units, its counters "
                f"{summary.counted_launches}: the trace lost records")
        if summary.handwritten == summary.counted_launches:
            summary.work_s = sum(cell.work(i).seconds()
                                 for i in range(first, first + k))
            return summary
        print(f"{lost}; profiling the next {k} units", file=sys.stderr)
    raise Failure(f"{lost} in {PROFILE_ATTEMPTS} blocks, so no metric is "
                  f"read from the device trace", 5)


def main(argv, t_start: float) -> int:
    try:
        return run(argv, t_start)
    except Failure as f:
        print(f"tomobench: {f}", file=sys.stderr)
        return f.code
