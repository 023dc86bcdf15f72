"""Run one cell of the port's benchmark on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``benchmark/README.md``."""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root, not benchmark/

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
