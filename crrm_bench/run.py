#!/usr/bin/env python3
"""The CRRM benchmark: one run of one cell on the card.

    python3 crrm_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, which holds the program under
``src/repro_torch`` and the manifest ``BENCHMARK.json``.  Prints one JSON
object as the last line of standard output (see ``harness/main.py``).
"""
import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from crrm_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.run(sys.argv[1:], root=ROOT, t_start=T_START))
