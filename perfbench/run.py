"""The benchmark's one command, run from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints one JSON result line (see README.md)."""

import sys
import time

T_START = time.perf_counter()  # set-up counts from here

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from perfbench import harness

    sys.exit(harness.run(sys.argv[1:], t_start=T_START))
