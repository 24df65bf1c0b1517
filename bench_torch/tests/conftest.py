"""The benchmark's own tests, on the CPU: `python -m pytest bench_torch/tests -q`
from the root of the checkout. They drive the harness's functions with
the program's and the reference's plain versions at tiny sizes; none
drives the command on a card."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.append(path)
