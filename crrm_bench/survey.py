#!/usr/bin/env python3
"""The readings that the limits of ``limits/<workload>.json`` are set from.

    python3 crrm_bench/survey.py --workload <name> --seeds 11,12,13 \\
        --seconds 3 [--control]

Runs the cell once per seed in this one process, with a short window, and
prints each compared number of each seed.  ``--control`` puts the plain
reference computed in bfloat16 in the program's place: the control that
every limit has to fail.  Not part of a benchmark run.
"""
import argparse
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from crrm_bench.harness import main  # noqa: E402


def survey(workload, seeds, seconds, control, device="cuda", root=ROOT):
    """``{seed: {number: value}}`` of one run per seed."""
    out = {}
    for seed in seeds:
        buf = io.StringIO()
        rc = main.run(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", "0"],
                      root=root, device=device, t_start=time.perf_counter(),
                      out=buf, control=control)
        if rc:
            raise SystemExit(rc)
        res = json.loads(buf.getvalue().splitlines()[-1])
        out[seed] = {k: v["value"] for k, v in res["check"].items()}
        out[seed]["correct"] = res["correct"]
        print(json.dumps({"workload": workload, "seed": seed,
                          "control": control, "numbers": out[seed]}),
              flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args()
    survey(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds,
           a.control)
