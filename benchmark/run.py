#!/usr/bin/env python3
"""Run one benchmark cell once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (`harness/runner.py` says
what it holds); without a CUDA card the run exits non-zero and prints
none."""

import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.run(sys.argv[1:], t_start=T_START))
