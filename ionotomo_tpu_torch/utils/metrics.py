"""Structured metrics: JSONL per-iteration records + profiling helpers
(port of ``ionotomo_tpu.utils.metrics``; SURVEY.md §5.1/§5.5).

The solvers return diagnostics and the host shell appends one JSON object
per iteration to a .jsonl stream; plots are regenerated from the stream
afterwards, never from inside the loop. Where the reference annotates and
captures with ``jax.profiler``, ``trace`` is a ``torch.profiler``
``record_function`` span and ``profile_to`` writes a ``torch.profiler``
trace (Chrome trace JSON, CPU and, on the card, CUDA activity) into the
directory.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager


class MetricsWriter:
    """Append-only JSONL metrics stream."""

    def __init__(self, path):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, record: dict):
        record = dict(record)
        record.setdefault("t_wall", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def read_all(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


@contextmanager
def trace(name: str):
    """A named span around a kernel group in a ``torch.profiler`` trace
    (``record_function``; free when no profiler runs)."""
    import torch
    with torch.profiler.record_function(name):
        yield


@contextmanager
def profile_to(logdir: str):
    """Capture a trace of the enclosed block into ``logdir``:
    ``with profile_to("/tmp/trace"): run()`` writes
    ``logdir/trace_<pid>_<time>.json`` (open it in Perfetto or
    chrome://tracing). CUDA activity is recorded when the card is
    present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextmanager
def timed(records: dict, key: str):
    """Context timer: records wall seconds under ``key``."""
    t0 = time.perf_counter()
    yield
    records[key] = records.get(key, 0.0) + time.perf_counter() - t0


def rates(n_rays: int, n_steps: int, seconds: float) -> dict:
    """Derived throughput counters (the BASELINE.json metric family)."""
    return {
        "rays_per_sec": n_rays / seconds if seconds > 0 else float("inf"),
        "ray_steps_per_sec": n_rays * n_steps / seconds
        if seconds > 0 else float("inf"),
        "seconds": seconds,
    }
