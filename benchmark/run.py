"""Run one cell of the benchmark once, on this machine's CUDA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as one JSON object on the last line of standard
output, and each compared number beside its limit as the last lines of
standard error. Exits non-zero, printing no result, without a CUDA card
(or with fewer than the cell asks for), when a file of the benchmark or
the program is missing, and when the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with few threads. The port's host work on this path (the
# batcher's bookkeeping, deskew's point search in NumPy) runs on the
# calling thread whatever the pools hold; the pools serve host-side BLAS
# and torch CPU operators, which the path uses only on a few dozen points
# (deskew's hull), and their spinning threads would take cores from the
# calling thread on a host whose cores other work shares.
for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_name, "1")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
