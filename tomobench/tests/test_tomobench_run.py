"""The harness end to end on the CPU at tiny sizes: each cell found by
name, the last line's keys, the comparison passing on the program and
failing on planted faults."""
from __future__ import annotations

import pytest

from conftest import workloads

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", workloads())
def test_cell_runs_and_is_correct(cpu_run, workload):
    code, line, err = cpu_run(workload)
    assert code == 0, err
    assert list(line) == KEYS
    assert line["correct"] is True, err
    assert line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert "setup_s" in line["metrics"]
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    assert err.strip().splitlines()[-1].startswith("check ")
