"""Tiny versions of the benchmark's cells for the CPU, and a run of the
harness on them with the search for a card stubbed out (the program runs
its plain PyTorch versions on the CPU)."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tomobench.harness import main  # noqa: E402

_SPEC_OF = main.spec_of

TINY_WORLD = {"n_ants": 6, "n_dirs": 5, "shape": [16, 16, 16],
              "trace_steps": 16}
TINY_TRUTH = {"n_modes": 32}
TINY = {
    "c4_cubic256": {"solve": {"samples": 9, "inner_samples": 5,
                              "cg_step1": 4, "cg_step2": 3}},
    "c5_zp128": {"world": {"nt": 4}},
}
TINY_MIX = {"map_solve": {"bank": 3},
            "bent_screen": {"directions": 7, "steps": 8,
                            "compare_epochs": 2, "profile_units": 2}}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


def tiny_spec(workload: str) -> dict:
    """The cell's spec with every size cut for the CPU; its limits are the
    cell's own."""
    spec = _SPEC_OF(workload)
    conf = spec["cell"]["config"]
    cfg = _merge(spec["config"], {"world": dict(TINY_WORLD,
                                                truth=TINY_TRUTH)})
    spec["config"] = _merge(cfg, TINY.get(conf, {}))
    spec["mix"] = _merge(spec["mix"], TINY_MIX[spec["cell"]["traffic"]])
    return spec


def workloads() -> list:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def _cpu_traced(cell, n, mix, kernels):
    """The profiled block on the CPU, which has no device trace: its units
    run, and each is read as one 10 us kernel inside its span."""
    from tomobench.harness import trace
    k = int(mix["profile_units"])
    events = []
    for j, i in enumerate(range(n, n + k)):
        cell.unit(i)
        events += [{"ph": "X", "cat": "user_annotation",
                    "name": trace.UNIT_SPAN, "ts": 100 * j, "dur": 100},
                   {"ph": "X", "cat": "kernel", "name": "unit_kernel",
                    "ts": 100 * j + 10, "dur": 10}]
    summary = trace.Summary(events, k, frozenset(), 0)
    summary.work_s = sum(cell.work(i).seconds() for i in range(n, n + k))
    return summary


@pytest.fixture
def cpu_run(monkeypatch, capsys):
    """run(workload, seed) → (exit code, last line or None, stderr): the
    harness's run on the CPU at the tiny sizes, with ``seconds`` 0 (one
    unit) unless given."""
    monkeypatch.setattr(main, "DEVICE", ("cpu",))
    monkeypatch.setattr(main, "spec_of", tiny_spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d=None: 0)
    monkeypatch.setattr(main, "_traced", _cpu_traced)

    def run(workload, seed=2 ** 31 + 7, seconds=0.0):
        code = main.main(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", "0"], 0.0)
        out, err = capsys.readouterr()
        lines = [x for x in out.splitlines() if x.strip()]
        return code, json.loads(lines[-1]) if lines and code == 0 else None, err

    return run
