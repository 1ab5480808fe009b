"""Entry point of the benchmark: ``python3 hassbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the root of a
checkout. Prints one JSON object as its last line (see
``hassbench/harness.py``)."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# one thread in each of the host's pools, set before numpy and torch load:
# a round's host half runs on the main thread, and the run keeps to one
# process with few threads on a host that others share
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

if __name__ == "__main__":
    from hassbench import harness
    sys.exit(harness.main(t_start=T_START))
