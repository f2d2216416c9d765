"""The benchmark of the PyTorch / CUDA port's buffer-pool simulator.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout: one run of one cell of ``BENCHMARK.json``,
whose last line on standard output is the result (see
``portbench/harness.py``).
"""

import time

T0 = time.time()   # the process's start, as near as this file can take it

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from portbench import harness
    raise SystemExit(harness.main(sys.argv[1:], T0))
