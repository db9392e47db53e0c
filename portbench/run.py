"""One run of one cell of the benchmark of deepfactors_tpu_torch.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA devices.
Prints one JSON line (the last of standard output); the numbers its check
compared, each beside its limit, are the last lines of standard error.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
