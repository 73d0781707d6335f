"""Run one cell of the benchmark once and print its result.

    python3 dcsbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of the repository.  The last line of standard output is the
result (JSON); the numbers that decided ``correct`` are also the last
lines of standard error.  Exits 2 without the CUDA cards the cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dcsbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
