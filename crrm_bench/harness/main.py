"""One benchmark run: load, warm up, measure, check, print one JSON line.

    python3 crrm_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` profiles a window of the traffic file's
``trace_calls`` calls and reports the cell's per-layer metrics.  Each
metric is read by its own reader, ``metrics/<name>.py``, from the trace
(``None`` in an untraced run) and the run's context.  Both
check the outputs of the window's last call against the plain reference
(``harness/check.py``) once the window has closed and the peak memory has
been read, and print each compared number beside its limit as the last
lines on standard error and under ``check`` in the result's line.

A cell over several ranks (``harness/ranks.py``) is read as one result:
the fullest rank's peak memory, the failed calls of all ranks, the
forbidden modules of any rank, rank 0's trace for the per-layer metrics
and the busy seconds averaged over the ranks; each rank's own readings go
under ``device.ranks`` and its launches on the path line.  ``correct``
judges rank 0, which holds the global outputs.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import resource
import sys
import time
from pathlib import Path

import numpy as np

#: top-level module names the run must not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(msg: str) -> int:
    print(f"crrm_bench: {msg}", file=sys.stderr, flush=True)
    return 2


def _kernels() -> dict:
    """The kernel wrappers whose launches the path line counts; the
    re-pricing kernel's only where the run has loaded it, so that counting
    imports nothing."""
    from repro_torch.kernels import fused_sinr, pairwise_dist
    out = {"fused_sinr": fused_sinr.fused_sinr_accumulate,
           "pairwise_dist": pairwise_dist.pairwise_dist}
    reprice = sys.modules.get("repro_torch.kernels.reprice_cells")
    if reprice is not None:
        out["reprice_cells"] = reprice.reprice_cells
    return out


def launch_counts() -> dict:
    counts = {k: fn.launches for k, fn in _kernels().items()}
    counts.setdefault("reprice_cells", 0)
    return counts


def zero_launches():
    for fn in _kernels().values():
        fn.launches = 0


class HostLog:
    """What the host did over a stretch: the process's CPU seconds, the
    times the OS took the CPU from it, and Python's garbage collections
    with their seconds.  Printed on the path line, to tell a slow host from
    slow work."""

    def __init__(self):
        self.gc_n, self.gc_s, self._t = [0, 0, 0], 0.0, None
        self.cpu0 = time.process_time()
        self.ivcsw0 = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n[info["generation"]] += 1

    def close(self) -> dict:
        gc.callbacks.remove(self._gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"cpu_s": time.process_time() - self.cpu0,
                "involuntary_switches": ru.ru_nivcsw - self.ivcsw0,
                "gc_collections": self.gc_n, "gc_s": self.gc_s}


def run(argv, *, root: Path, device: str = "cuda", t_start=None,
        out=sys.stdout, control=False, worker_hook=None) -> int:
    """The run; returns the exit code.  ``device="cpu"`` is for the tests
    of the harness alone: a benchmark run is on the card.  ``control``
    puts the reference, computed in bfloat16, in the program's place.
    ``worker_hook(rank)``, a picklable callable, runs first in each worker
    rank of a cell over several ranks: the tests break a rank with it."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch
    phases = [("torch_import", time.perf_counter())]
    if device == "cuda":
        if not torch.cuda.is_available():
            return _fail("no CUDA device: the benchmark measures the card")
    if not (Path(root) / "src" / "repro_torch").is_dir():
        return _fail(f"the program (src/repro_torch) is not under {root}")
    from crrm_bench.harness import manifest
    cell = manifest.cell(root, args.workload, Path(root) / "crrm_bench")
    if device == "cuda" and torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} devices; "
                     f"{torch.cuda.device_count()} present")
    kind = manifest.entry_kind(cell.bench_dir, cell.traffic["entry"])
    spans = kind.Entry.spans_ranks
    if cell.chips == 1 and not spans:
        phases.append(("harness", time.perf_counter()))
        return _measure(args, cell, kind, device, t_start, phases, out,
                        control)
    if not spans:
        return _fail(f"{args.workload} asks for {cell.chips} chips; its "
                     f"entry kind {cell.traffic['entry']!r} runs on one")
    from crrm_bench.harness import ranks
    with ranks.Team(cell, args.seed, args.seconds, args.trace, device,
                    t_start, worker_hook) as team:
        phases.append(("harness", time.perf_counter()))
        return _measure(args, cell, kind, device, t_start, phases, out,
                        control, team)


def _measure(args, cell, kind, device, t_start, phases, out, control,
             team=None) -> int:
    """Set up, warm up, measure, check and print; ``team`` runs the other
    ranks of a cell over several (``harness/ranks.py``)."""
    import torch
    from crrm_bench.harness import check, manifest, trace
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.reset_peak_memory_stats()
    phases.append(("cuda_context", time.perf_counter()))
    if team is None:
        entry = kind.Entry(cell, args.seed, device)
    else:
        entry = kind.Entry(cell, args.seed, team.device, ranks=team.join())
        sync = team.sync
        phases.append(("ranks", time.perf_counter()))
    reads = None
    try:
        entry.setup()
        sync()
        phases.append(("setup", time.perf_counter()))
        entry.warmup()
        sync()
        phases.append(("warmup", time.perf_counter()))
        setup_s = time.perf_counter() - t_start
        t_prev, setup_phases = t_start, {}
        for name, t in phases:
            setup_phases[name], t_prev = t - t_prev, t
        zero_launches()
        step_ms, calls = [], 0

        def window(n_calls=None):
            nonlocal calls
            t0 = time.perf_counter()
            while True:
                c0 = time.perf_counter()
                if team is not None:
                    team.go()
                entry.call()
                sync()
                step_ms.append((time.perf_counter() - c0) * 1e3)
                calls += 1
                if n_calls is None:
                    if time.perf_counter() - t0 >= args.seconds:
                        break
                elif calls >= n_calls:
                    break
            if team is not None:
                team.stop()
            return time.perf_counter() - t0

        tr = None
        host = HostLog()
        if args.trace:
            tr = trace.profile(
                lambda: window(int(cell.traffic["trace_calls"])))
            window_s = tr.window_s
        else:
            window_s = window()
        host = host.close()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        counts = launch_counts()
        if team is not None:
            from crrm_bench.harness import ranks
            reads = team.gather(ranks.report(entry, team.device, calls, tr))
            peak = max(r["memory_peak_bytes"] for r in reads)
        ttis = entry.ttis(calls)
        half = len(step_ms) // 2
        path = {
            "route": entry.route(), "calls": calls, "ttis": ttis,
            "launches": counts,
            "launches_per_tti": {k: v / ttis for k, v in counts.items()},
            "call_ms_p10_p50_p90": np.percentile(step_ms, [10, 50, 90])
            .tolist(),
            "call_ms_median_by_half": [float(np.median(step_ms[:half])),
                                       float(np.median(step_ms[half:]))]
            if half else None,
            "call_ms_p95_p99_max": np.percentile(step_ms, [95, 99, 100])
            .tolist(),
            "call_ms_p95_by_quarter": [
                float(np.percentile(q, 95))
                for q in np.array_split(np.asarray(step_ms), 4)]
            if len(step_ms) >= 4 else None,
            "setup_phases_s": setup_phases, "window_host": host}
        if reads is not None:
            path["ranks"] = [{k: r[k] for k in ("rank", "calls", "launches")}
                             for r in reads]
        print(json.dumps({"path": path}), file=out, flush=True)
        ctx = {"ttis": ttis, "params": entry.params,
               "window_s": window_s, "call_ms": step_ms,
               "peak_bytes": peak, "setup_s": setup_s,
               "fused_sinr_rows": entry.dirty_rows(calls),
               "fused_sinr_launches": counts["fused_sinr"]}
        failed = entry.failed() if reads is None else sum(
            r["failed"] for r in reads)
        # -- correct: the window's last call against the reference ------
        prog = entry.program_outputs()
        if cuda:
            torch.cuda.empty_cache()
        ref = entry.reference_outputs(prog, torch.float32)
        if control:
            prog = entry.reference_outputs(prog, torch.bfloat16)
        nums = kind.numbers(prog, ref)
        correct, rows = check.verdict(nums, cell.limits)
    finally:
        entry.close()
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        v = manifest.reader(cell.bench_dir, m["name"])(tr, ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": calls,
              "failed": failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = trace.busy_s(tr)
        dev["window_s"] = tr.window_s
        result["breakdown"] = trace.breakdown(tr)
    if reads is not None:
        keys = ("rank", "memory_peak_bytes", "busy_s", "window_s")
        dev["ranks"] = [{k: r[k] for k in keys if k in r} for r in reads]
        if args.trace:
            dev["busy_s"] = sum(r["busy_s"] for r in reads) / len(reads)
    # a non-finite number is printed as its name: JSON has no NaN
    num = lambda x: x if math.isfinite(x) else str(x)
    result["check"] = {name: {"value": num(v), "limit": num(lim)}
                       for name, v, lim in rows}
    bad = forbidden_modules()
    if reads is not None:
        bad = sorted(set(bad).union(*(r["forbidden"] for r in reads)))
    if bad:
        return _fail(f"modules of JAX or the JAX package loaded: {bad}")
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
