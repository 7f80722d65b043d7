#!/usr/bin/env python3
"""Run one cell of the benchmark of pdwt_tpu_torch once, from the root of
a checkout:

    python3 wavebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints one JSON line last on standard output (``harness.py``) and the
numbers of its check, each beside its limit, last on standard error.  It
needs a CUDA card and exits with another code than 0, printing no result,
without one.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[0] = ROOT  # the checkout, not this folder, as the root of imports
    from wavebench import harness

    os.environ.update(harness.cache_env(ROOT))
    sys.exit(harness.main(sys.argv[1:], T0))
