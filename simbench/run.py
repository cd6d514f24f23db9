"""The benchmark's command, run from the root of a checkout:

    python3 simbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It puts the checkout's root and ``src/`` on the path itself and runs
``simbench.harness.main``."""
import time

T_START = time.perf_counter()

import os
import sys
from pathlib import Path

# one process, few threads: thread pools on tiny host arrays add noise
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root replaces this script's folder on the path, so no
# module of simbench shadows a library's
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from simbench.harness import main

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
