"""The harness's pieces on the CPU: every cell's files found by name from
BENCHMARK.json alone, the import checks by whole top-level names, the
trace's reading, each driver's work count against a hand count, and the
reference against the program at tiny sizes."""
from __future__ import annotations

import json
import math
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, tiny_spec, workloads
from tomobench.harness import main, trace, work


@pytest.mark.parametrize("workload", workloads())
def test_cell_files_found_by_name(workload):
    spec = main.spec_of(workload)
    driver = spec["mix"]["driver"]
    assert (ROOT / "tomobench" / "drivers" / f"{driver}.py").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(main.reader(m["name"]), "read"), m["name"]
    assert {"setup_s"} < {m["name"] for m in spec["end_to_end"]}
    assert spec["per_layer"]
    assert set(spec["limits"]) >= {"repeat_mismatches"}


def test_benchmark_json_contract_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in names
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "ionotomo_tpu_torch_lookalike",
                        SimpleNamespace())
    assert "ionotomo_tpu" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ionotomo_tpu.core", SimpleNamespace())
    assert main.forbidden_modules() == ["ionotomo_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import tomobench.reference.operator, tomobench.reference.solve,"
            " tomobench.reference.tracer\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'ionotomo_tpu_torch', 'ionotomo_tpu', "
            "'jax', 'jaxlib', 'flax', 'bench'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_a_run_loads_no_jax(cpu_run):
    code, line, err = cpu_run("c5_zp128.bent_screen")
    assert code == 0, err
    assert main.forbidden_modules() == []


def test_trace_summary_reads_busy_idle_and_launches():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [
        x("user_annotation", "tomobench.unit", 0, 100),
        x("user_annotation", "tomobench.unit", 100, 100),
        x("user_annotation", "tomobench.trace", 0, 90),
        x("user_annotation", "tomobench.trace", 100, 90),
        x("kernel", "void trace_ordered_kernel<false, 2, ZpValueGrad>(int)",
          10, 40),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>(x)",
          30, 30),
        x("gpu_memcpy", "Memcpy DtoH", 150, 10),
        x("kernel", "regular_fft_factor<256>", 300, 10),  # outside
    ]
    s = trace.Summary(events, 2, frozenset({"trace_ordered_kernel"}), 1)
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(60e-6)        # [10, 60] and [150, 160]
    assert s.launches == 3 and s.handwritten == 1
    gaps = dict((round(v * 1e6), n) for n, v in s.idle_gaps)
    assert gaps[90] == "tomobench.trace"           # 60 .. 150
    assert gaps[10] == "tomobench.trace"           # 0 .. 10
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(140e-6)


def test_trace_device_ms_reads_busy_time_a_trace(cpu_run):
    code, line, err = cpu_run("c5_zp128.bent_screen")
    assert code == 0, err
    metric = line["metrics"]["trace_device_ms"]
    assert metric["unit"] == "ms"
    assert metric["value"] == pytest.approx(0.01, rel=1e-12)
    assert "busy_s" not in line["device"] and "breakdown" not in line
    solve = SimpleNamespace(layer_unit=("solve", 1))
    assert main.reader("trace_device_ms").read("trace_device_ms", {
        "summary": SimpleNamespace(busy_s=1.0, n_units=2),
        "cell": solve}) is None


def test_a_block_that_lost_records_is_profiled_again(monkeypatch, capsys):
    firsts, blocks_lost = [], [2]

    def profile(unit, first, k, out_dir, launches_now):
        firsts.append(first)
        lost = len(firsts) <= blocks_lost[0]
        return SimpleNamespace(handwritten=738 if lost else 740,
                               counted_launches=740)

    monkeypatch.setattr(trace, "profile", profile)
    cell = SimpleNamespace(unit=None, work=lambda i: work.Work())
    mix, kernels = {"profile_units": 5}, SimpleNamespace(launches={})
    summary = main._traced(cell, 100, mix, kernels)
    assert firsts == [100, 105, 110] and summary.work_s == 0.0
    assert "lost records" in capsys.readouterr().err
    firsts.clear()
    blocks_lost[0] = main.PROFILE_ATTEMPTS
    with pytest.raises(main.Failure, match="in 3 blocks"):
        main._traced(cell, 100, mix, kernels)


def test_handwritten_names_parse_the_program_sources():
    from ionotomo_tpu_torch import kernels
    from pathlib import Path
    names = trace.handwritten_names(Path(kernels.__file__).parent / "csrc")
    assert {"trace_ordered_kernel", "rows_value_fwd_kernel",
            "pack_members_kernel", "zp_value_grad_bwd_kernel"} <= names
    assert trace.base_name("void (anonymous namespace)::zpc_value_grad_"
                           "kernel(float const*)") == "zpc_value_grad_kernel"


def _cell(workload):
    import importlib
    spec = tiny_spec(workload)
    driver = importlib.import_module(
        f"tomobench.drivers.{spec['mix']['driver']}")
    return driver.Cell(spec["config"], spec["mix"], 11,
                       torch.device("cpu")), spec


def test_bent_trace_work_against_a_hand_count():
    cell, spec = _cell("c5_zp128.bent_screen")
    v, nz, r, steps = 16 ** 3, 16, 6 * 7, 8
    hand = (max((2 * nz * v + 16 * v) / 67e12,
                (8 * v + 4 * nz * nz) / 3.35e12)
            + max(r * steps * 470 / 67e12, 40 * r / 3.35e12))
    assert cell.work(0).seconds() == pytest.approx(hand, rel=1e-12)


def test_map_solve_work_against_a_hand_count():
    cell, spec = _cell("c4_cubic256.map_solve")
    s = spec["config"]["solve"]
    v, nz, r = 16 ** 3, 16, 30
    log2v = math.log2(v)

    def t(f, b):
        return max(f / 67e12, b / 3.35e12)

    hand = 0.0
    for n_s, it in ((s["inner_samples"], s["cg_step1"]),
                    (s["samples"], s["cg_step2"])):
        n, d = r * n_s, cell._touched[n_s]
        ends = 2 * r
        op_f = n * (2 * 64 + 4) + ends * (8 * 64 + 12) + 4 * r
        state = 4 * (n + 2 * ends)
        half = v // nz * (nz // 2 + 1)
        hand += t(20 * n, 12 * n)
        hand += t(op_f + 2 * (n + ends), 4 * d + 4 * r + 4 * (n + 2 * ends))
        hand += (3 + it) * t(op_f, 4 * d + state + 4 * r)
        hand += (2 + it) * t(op_f, 4 * r + state + 4 * v)
        hand += (4 + 2 * it) * t(5 * v * log2v + 2 * half, 8 * v + 4 * half)
        hand += it * t(10 * v, 28 * v) + (3 + it) * t(v, 12 * v)
    cell.unit(0)
    assert cell.work(0).seconds() == pytest.approx(hand, rel=1e-12)


@pytest.mark.parametrize("workload", workloads())
def test_reference_agrees_with_the_program_and_the_control_does_not(
        workload):
    cell, spec = _cell(workload)
    cell.unit(0)
    numbers, failed = cell.check(spec["limits"])
    assert failed == 0
    for name, v, lim in numbers:
        assert v <= lim, (name, v, lim)
    cell, spec = _cell(workload)
    control = cell.control()
    assert any(v > spec["limits"][k] for k, v in control.items()
               if k in spec["limits"]), control
