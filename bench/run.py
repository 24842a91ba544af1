"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port
(``src/repro_torch``).  The last line of standard output is the result's
JSON object; the last lines of standard error give each number compared
beside its limit.  Without the CUDA devices the cell asks for, it exits
with 2 and prints no result.  See ``gcvbench/harness.py``.
"""
import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
# Python's bytecode of every module this process imports (torch's own
# included, whose installation may keep none, and under an environment
# that may forbid writing it) is cached inside the checkout, so that only
# a checkout's first run compiles it.
sys.pycache_prefix = str(HERE.parent / "build" / "pycache")
sys.dont_write_bytecode = False

from gcvbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
