"""Episode reports: written work counts, a measured run and the roofline.

The port of ``repro.obs.report``.  The reference lowers and compiles the
episode rollout and reads XLA's cost analysis without running a TTI.
Eager PyTorch has no compiler cost analysis and cannot lower a program
without running it, so :func:`episode_report` does two things instead:

* it counts the rollout's work with written formulas
  (:func:`analytic_counts`): the radio rows as the kernels' own ``work``
  counts them, plus a stated count for the rest of each TTI.  The
  artifact carries them as ``analytic_flops`` / ``analytic_bytes``, which
  :func:`repro_torch.analysis.roofline.from_artifact` prefers;
* it runs the rollout once under :func:`repro_torch.obs.profile.trace` and
  records what it measured: wall ms and device ms per TTI, device kernel
  launches per TTI, the hand-written kernels' launches, and the
  collectives' wire bytes (``core.distributed.count_collectives``).

Run as a module to write per-scenario JSON artifacts and the markdown
roofline table:

    PYTHONPATH=src python -m repro_torch.obs.report --scenario dense_urban \\
        --n-tti 20 --out artifacts/obs [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch import resolve_device, tree
from repro_torch.analysis import roofline
from repro_torch.core import distributed
from repro_torch.kernels import fused_sinr, pairwise_dist
from repro_torch.mac.engine import Draws
from repro_torch.obs import profile

#: float32 operations per (UE, frequency chunk) and TTI outside the radio
#: rows: SINR w / (noise + u) 2; to dB (log, scale, add) 3; CQI 15 (one
#: compare per step of the staircase); the pf weight (rate, ratio to the
#: average, power) 3; the cell's max and sum of weights 2; the share and
#: the served bits 3; the average's update 3
REST_OPS_PER_UE_FREQ = 31
#: float32 operations per UE and TTI outside the radio rows: the walk
#: (add and clamp per coordinate) 4, arrivals and backlog 3, the HARQ
#: draw and compare 2
REST_OPS_PER_UE = 9


def model_flops_episode(n_ues: int, n_cells: int, n_freq: int,
                        n_tti: int) -> float:
    """Useful-physics FLOPs of ``n_tti`` dense radio TTIs (an estimate).

    Per (UE, cell) link and TTI the Figure-1 chain costs roughly:
    geometry + pathloss + antenna ~ 40 flops, then RSRP/interference/SINR
    ~ 6 per frequency chunk; the MAC adds ~ 10 per (UE, chunk).  The
    point is a stable order-of-magnitude yardstick for the roofline's
    useful/counted ratio, not an exact count.
    """
    radio = n_ues * n_cells * (40.0 + 6.0 * n_freq)
    mac = 10.0 * n_ues * n_freq
    return float(n_tti) * (radio + mac)


def radio_rows(params, n_ues: int) -> tuple:
    """``(rows computed once at the rollout's start, rows per TTI)`` of the
    radio chain, as the engine's configuration fixes them: under static
    geometry the chain's outputs are the episode's static inputs (0, 0);
    a dense chain recomputes every row each TTI (0, N); the incremental
    one builds its state over every row once and recomputes the window's
    movers each TTI (N, max(1, round(frac * N))), every row when no
    fraction is set."""
    if not params.mobility_step_m:
        return 0, 0
    if params.radio_mode != "incremental":
        return 0, n_ues
    frac = params.mobility_move_frac
    moved = (n_ues if frac is None or frac >= 1.0
             else max(1, int(round(frac * n_ues))))
    return n_ues, moved


def _nbytes(x) -> int:
    """Bytes of the tensors of a static or state tuple, its fading tensor
    left out: the radio rows read their fading rows and no other part of
    a TTI reads it."""
    return sum(t.numel() * t.element_size()
               for t in tree.flatten(x._replace(fad=None))[1]
               if isinstance(t, torch.Tensor))


def analytic_counts(sim, static, state, n_tti: int) -> dict:
    """Written counts of one rollout's work: ``{"flops", "bytes", ...}``
    with each term beside the totals.

    * Radio rows: :func:`repro_torch.kernels.fused_sinr.work` on the rows
      :func:`radio_rows` names, against every cell: its operations per
      link, and the bytes of the rows' positions, fading rows and index
      read once and their outputs written once.  This is the function's
      work whichever route computes it.
    * The rest of each TTI: :data:`REST_OPS_PER_UE_FREQ` per (UE,
      frequency chunk) and :data:`REST_OPS_PER_UE` per UE; its bytes are
      the static inputs read once, the episode state read once and
      written once, and the TTI's throughput row written once (the
      fading tensor of either only as the radio rows read it).
    """
    p = sim.params
    n, m = sim.n_ues, sim.n_cells
    k, f = static.P.shape[1], p.n_freq
    model_id = sim.radio_config().pathgain_fn.kernel_spec()[0]
    fad_row = (static.fad[0].numel()
               if p.rayleigh_fading and static.fad is not None else 0)
    init_rows, tti_rows = radio_rows(p, n)

    def rows_work(rows, by_index):
        if rows == 0:
            return 0, 0
        return fused_sinr.work(rows, m, k, rows * fad_row, model_id,
                               p.n_sectors, 4 * rows if by_index else 0)

    incremental = p.radio_mode == "incremental"
    init_ops, init_bytes = rows_work(init_rows, False)
    row_ops, row_bytes = rows_work(tti_rows, incremental)
    rest_ops = REST_OPS_PER_UE_FREQ * n * f + REST_OPS_PER_UE * n
    rest_bytes = _nbytes(static) + 2 * _nbytes(state) + 4 * n
    return {
        "flops": float(init_ops + n_tti * (row_ops + rest_ops)),
        "bytes": float(init_bytes + n_tti * (row_bytes + rest_bytes)),
        "rows_init": init_rows, "rows_per_tti": tti_rows,
        "radio_flops_per_tti": float(row_ops),
        "radio_bytes_per_tti": float(row_bytes),
        "rest_flops_per_tti": float(rest_ops),
        "rest_bytes_per_tti": float(rest_bytes),
    }


def _launches():
    return {"fused_sinr": fused_sinr.fused_sinr_accumulate.launches,
            "pairwise_dist": pairwise_dist.pairwise_dist.launches}


def episode_report(sim, n_tti: int, *, mesh=None, scenario: str = "",
                   telemetry: bool = False, action=None,
                   inc_backend=None) -> dict:
    """Count, run once and measure the episode rollout of one simulator.

    Returns a roofline-ready artifact dict (see
    :func:`repro_torch.analysis.roofline.from_artifact`): the reference's
    keys (``n_devices``, ``model_flops``, ``collective_wire_bytes``, ...)
    with ``analytic_flops``/``analytic_bytes`` in place of XLA's counts,
    and the measured ``wall_ms_per_tti`` (host clock, synchronised),
    ``device_ms_per_tti`` (the trace's device kernel time),
    ``launches_per_tti`` (device kernels in the trace) and
    ``kernel_launches`` (the hand-written kernels' counters over the
    rollout).  Per-TTI numbers are the rollout's over ``n_tti``, its
    set-up included, as the counts include it.  On the CPU the device
    numbers are None: there is no device.  A configuration that cannot
    run raises.
    """
    fns = sim.episode_fns(mesh=mesh, telemetry=telemetry,
                          inc_backend=inc_backend)
    static = sim.episode_static()
    state = sim.init_episode_state()
    n_dev = 1 if mesh is None else math.prod(mesh.shape.values())
    counts = analytic_counts(sim, static, state, n_tti)
    draws = Draws(sim.params.seed, sim.device)
    on_card = sim.device.type == "cuda"
    before = _launches()
    with tempfile.TemporaryDirectory(prefix="report-") as d, \
            profile.trace(d) as prof, \
            distributed.count_collectives() as coll:
        t0 = time.perf_counter()
        out = fns.rollout(static, state, n_tti, draws, action)
        profile.synchronize(out)
        wall = time.perf_counter() - t0
    kernels = profile.kernel_times(prof) if on_card else {}
    after = _launches()
    return {
        "scenario": scenario, "n_ues": sim.n_ues, "n_cells": sim.n_cells,
        "n_tti": int(n_tti), "n_devices": n_dev,
        "model_flops": model_flops_episode(
            sim.n_ues, sim.n_cells, sim.params.n_freq, n_tti),
        "backend": sim.device.type,
        "device": (torch.cuda.get_device_name(sim.device) if on_card
                   else "cpu"),
        "inc_backend": fns.inc_backend,
        "analytic_flops": counts.pop("flops"),
        "analytic_bytes": counts.pop("bytes"),
        "analytic_breakdown": counts,
        "collective_wire_bytes": coll.total_wire_bytes,
        "collective_counts": dict(coll.counts),
        "wall_ms_per_tti": wall * 1e3 / n_tti,
        "device_ms_per_tti": (sum(us for us, _ in kernels.values())
                              / 1e3 / n_tti if on_card else None),
        "launches_per_tti": (sum(c for _, c in kernels.values()) / n_tti
                             if on_card else None),
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }


def roofline_table(artifacts: dict) -> str:
    """Markdown roofline table over ``{name: artifact}`` dicts."""
    lines = ["| cell | compute ms | memory ms | collective ms | dominant "
             "| useful/HLO | roofline frac |",
             "|---|---|---|---|---|---|---|"]
    for name in sorted(artifacts):
        art = artifacts[name]
        if art.get("skipped"):
            lines.append(f"| {name} | - | - | - | skipped: "
                         f"{art.get('reason', '')[:40]} | - | - |")
        else:
            lines.append(roofline.format_row(name, art))
    return "\n".join(lines)


def write_report(out_dir: str, artifacts: dict) -> str:
    """Write per-name JSON artifacts + ``roofline.md``; returns the table."""
    os.makedirs(out_dir, exist_ok=True)
    for name, art in artifacts.items():
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(art, f, indent=2, sort_keys=True)
            f.write("\n")
    table = roofline_table(artifacts)
    with open(os.path.join(out_dir, "roofline.md"), "w") as f:
        f.write("# Episode roofline\n\n" + table + "\n")
    return table


def main(argv: Optional[list] = None) -> None:
    from repro_torch.core.crrm import CRRM
    from repro_torch.sim.scenarios import make_scenario, scenario_names

    ap = argparse.ArgumentParser(
        description="count, run and measure the episode rollout per "
                    "scenario")
    ap.add_argument("--scenario", action="append", default=None,
                    help="registry preset (repeatable; default: all)")
    ap.add_argument("--n-tti", type=int, default=20)
    ap.add_argument("--n-ues", type=int, default=None,
                    help="override the preset's UE count")
    ap.add_argument("--out", default="artifacts/obs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = args.scenario or list(scenario_names())
    arts = {}
    for name in names:
        overrides = {} if args.n_ues is None else {"n_ues": args.n_ues}
        sim = CRRM(make_scenario(name, **overrides), device=device)
        arts[name] = episode_report(sim, args.n_tti, scenario=name)
    print(write_report(args.out, arts))


if __name__ == "__main__":
    main()
