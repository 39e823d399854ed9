"""The benchmark of ionotomo_tpu_torch, one cell a run:

    python3 tomobench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints the run's result as one JSON object on its last line of
standard output, and the numbers it compared, each beside its limit, as
the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tomobench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
