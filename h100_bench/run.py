#!/usr/bin/env python3
"""Run one cell of the benchmark of `vampire_tpu_torch` once, on the card.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The last line of
standard output is the result (JSON); the numbers compared with the plain
reference, each with its limit, are the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import cli  # noqa: E402

if __name__ == '__main__':
    sys.exit(cli.main(t_start=T_START))
