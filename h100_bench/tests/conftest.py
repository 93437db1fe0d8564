"""The benchmark's own tests: `python -m pytest h100_bench/tests` from the
repository root. They import the harness and the reference from the
benchmark's folder, and the program from the root."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
