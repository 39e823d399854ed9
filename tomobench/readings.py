"""Readings that set a cell's limits, in one process on the card:

    python3 tomobench/readings.py --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--seconds 3] [--out FILE]

For each of ``--seeds``: the cell's set-up, a window of ``--seconds``, and
the numbers its check compares (the program against the plain
reference). For each of ``--control-seeds``: the same numbers with the
plain reference computed in TF32 put in the program's place (the
control). One JSON object a reading goes to standard output and, with
``--out``, to that file. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tomobench.harness import main as harness  # noqa: E402


def readings(workload, seeds, control_seeds, seconds, device=("cuda", 0)):
    import torch
    import ionotomo_tpu_torch  # noqa: F401  (turns TF32 off)

    spec = harness.spec_of(workload)
    driver = importlib.import_module(
        f"tomobench.drivers.{spec['mix']['driver']}")
    dev = torch.device(*device)
    for kind, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            cell = driver.Cell(spec["config"], spec["mix"], seed, dev)
            setup = time.perf_counter() - t0
            rec = {"workload": workload, "kind": kind, "seed": seed,
                   "setup_s": setup}
            if kind == "program":
                window = harness.Window(seconds)
                rec["units"] = window.run(cell.unit)
                t1 = time.perf_counter()
                numbers, failed = cell.check(spec["limits"])
                rec["check_s"] = time.perf_counter() - t1
                rec["failed"] = failed
                rec["numbers"] = {n: v for n, v, _ in numbers}
            else:
                t1 = time.perf_counter()
                rec["numbers"] = cell.control()
                rec["check_s"] = time.perf_counter() - t1
            del cell
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            yield rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    a = p.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    out = open(a.out, "a") if a.out else None
    try:
        for rec in readings(a.workload, ints(a.seeds),
                            ints(a.control_seeds), a.seconds):
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
