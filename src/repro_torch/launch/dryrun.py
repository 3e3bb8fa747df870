"""Dry-run cells: the crrm-ppp networks on one device, the LM cells
reckoned over the named meshes.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for a TPU pod and runs nothing.

**crrm-ppp.**  Each cell runs once, whole, through the step makers of
:mod:`repro_torch.core.distributed` on a mesh over the default process
group (a 1-rank NCCL group on the card, gloo on the CPU), and its artifact
records what the run measured beside the reference's analytic counts:
``<out>/<device>-1x1/crrm-ppp/<shape>.json`` with
``analytic_flops``/``analytic_bytes`` (the reference's formulas,
:func:`analytic_counts`), ``variant``, ``n_devices``,
``collective_wire_bytes`` (counted by ``core.distributed``),
``peak_bytes_per_device`` (``torch.cuda.max_memory_allocated``, in place
of XLA's memory analysis), ``device_ms`` / ``wall_ms`` of the one run and
its roofline row.  The cell's shapes (N, M, K, moves) are never cut; the
cell tile of the streamed variants is chosen to fit the device
(:func:`plan_cell`) and recorded under ``reduced`` when it is below the
step makers' default.  A cell that cannot fit raises with its reckoned
bytes.

**LM cells** (:func:`run_lm_cell`).  The named meshes (pod 16x16,
multipod 2x16x16) do not fit one host, so nothing runs: each cell's
artifact ``<out>/<mesh>/<arch>/<shape>.json`` holds the reference's
analytic fields -- ``param_counts``, ``analytic_flops``,
``analytic_flops_fwd``, ``analytic_bytes`` with its breakdown,
``model_flops`` -- the strategy and accumulation the reference's
``_lower_cell`` picks, and the per-device bytes of the cell's state
reckoned from the sharding rules' spec trees over the mesh
(``reckoned_bytes_per_device``: train cells the params and Adafactor's
state, serve cells the bf16 params and the cache; the same over a
(1, 1) mesh in ``reckoned_bytes_one_device``, with a floor under what a
train cell's step adds).  The reference's HLO
fields (``hlo_flops``, ``collective_*``, ``memory_analysis``) have no
source without a compiler and are absent, named in ``absent``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch crrm-ppp
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch crrm-ppp \\
      --shape net_256k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.analysis import roofline
from repro_torch.configs import LM_ARCH_IDS, crrm_ppp, get_config
from repro_torch.core import distributed as D
from repro_torch.sim.pathloss import make_pathloss

#: the step makers' cell tile, kept wherever it fits
DEFAULT_TILE = 512
#: the share of the device's free memory a cell may reckon to take
MEMORY_SHARE = 0.9
#: the network (the example-12 validation scaled up): a power-law
#: pathloss, 10 MHz and 10 W split over the subbands, cells every
#: ~500 m on average in a square, UEs at 1.5 m and cells at 25 m
ALPHA, NOISE_W, BANDWIDTH_HZ, POWER_W = 3.5, 1e-15, 1e7, 10.0
CELL_SPACING_M, H_UE, H_BS = 500.0, 1.5, 25.0


def analytic_counts(sh: dict) -> tuple:
    """``(flops, bytes)`` of one step of a cell: the reference's analytic
    model (``repro/launch/dryrun.py`` ``run_crrm_cell``).  ~60 executed
    flops per (UE, cell) pair (distance 10, power-law pathgain ~15,
    RSRP/argmax/accumulation ~35), K subbands folding into the
    accumulation; bytes: the materialized variant writes and reads the
    (N, M) D/G/R matrices (the paper's layout), the streamed ones touch
    O(N + M) per pass over cell tiles of 512."""
    N, M, K = sh["n_ues"], sh["n_cells"], sh["n_subbands"]
    rows = sh.get("max_moves", N)
    pair_flops = 60.0
    work = rows * M * pair_flops + rows * K * 30.0
    if sh["variant"] == "materialized":
        byts = rows * M * 4.0 * (3 + 2 + 2 * K) + rows * K * 4.0 * 8
    else:
        tiles = max(1, M // 512)
        byts = (rows * 3 * 4.0 * tiles      # U re-read per cell tile
                + M * (3 + K) * 4.0         # C, P once
                + rows * K * 4.0 * 10)      # O(N) state rw
    return work, byts


def reckon_bytes(variant: str, n_ues: int, rows: int, n_cells: int, k: int,
                 tile: int = 0) -> int:
    """Peak device bytes of one step, reckoned from the step makers' code.

    ``_geometry`` holds 7 float32 planes of (rows, cols) at its peak (dx,
    dy, dz, d2d and the three terms of d3d's sum).  The materialized step
    then holds d2d, d3d, g, the K planes of r and their row sum: max(7,
    4 + K) planes of (rows, M).  The streamed steps hold the previous
    tile's 4 + K planes while the next tile's geometry runs: 11 + K
    planes of (rows, tile).  Beside them, 30 + 12 K float32 per UE row
    bound the O(N) vectors (inputs, carried state, the running
    accumulators, the all-reduce copies and the outputs), and the field's
    cells."""
    if variant == "materialized":
        planes = max(7, 4 + k) * rows * n_cells
    else:
        planes = (11 + k) * rows * tile
    return 4 * (planes + (30 + 12 * k) * n_ues + (3 + k) * n_cells)


def plan_cell(sh: dict, budget: float) -> dict:
    """The tiles of a cell and its reckoned peak within ``budget`` bytes.

    Materialized: no tile.  Streamed: the largest power of two no larger
    than :data:`DEFAULT_TILE` whose reckoned peak fits.  The incremental
    cell streams its ``max_moves`` rows in the timed step and every row
    once before it (``setup_tile``: the carried state it starts from).
    Raises ``MemoryError`` with the reckoned bytes when nothing fits.
    """
    N, M, K = sh["n_ues"], sh["n_cells"], sh["n_subbands"]
    variant = sh["variant"]
    plan = {"reduced": []}

    def fit(rows, what):
        tile = min(DEFAULT_TILE, M)
        tile = 1 << (tile.bit_length() - 1)
        want = reckon_bytes(variant, N, rows, M, K, tile)
        while tile > 1 and reckon_bytes(variant, N, rows, M, K,
                                        tile) > budget:
            tile //= 2
        got = reckon_bytes(variant, N, rows, M, K, tile)
        if got > budget:
            raise MemoryError(f"crrm-ppp {variant} {N} x {M}: {what} needs "
                              f"{got / 1e9:.2f} GB reckoned at a cell tile "
                              f"of 1, over the {budget / 1e9:.2f} GB budget")
        if tile < min(DEFAULT_TILE, M):
            plan["reduced"].append(
                f"{what}: cell_tile {DEFAULT_TILE} -> {tile} ({rows} rows "
                f"streamed; reckoned peak {want / 1e9:.2f} GB at "
                f"{DEFAULT_TILE} over the {budget / 1e9:.2f} GB budget, "
                f"{got / 1e9:.2f} GB at {tile})")
        return tile, got

    if variant == "materialized":
        plan["reckoned_bytes"] = reckon_bytes(variant, N, N, M, K)
        if plan["reckoned_bytes"] > budget:
            raise MemoryError(f"crrm-ppp materialized {N} x {M} needs "
                              f"{plan['reckoned_bytes'] / 1e9:.2f} GB "
                              f"reckoned, over the {budget / 1e9:.2f} GB "
                              f"budget")
    elif variant == "streaming":
        plan["cell_tile"], plan["reckoned_bytes"] = fit(N, "the step")
    else:
        plan["setup_tile"], setup = fit(N, "the set-up over every row")
        plan["cell_tile"], step = fit(sh["max_moves"], "the step")
        plan["reckoned_bytes"] = max(setup, step)
    return plan


def budget_bytes(device) -> float:
    """:data:`MEMORY_SHARE` of what the device can still hand out: the
    card's free memory plus the allocator's cached blocks; the host's
    physical memory on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        free += (torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
    else:
        free = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return MEMORY_SHARE * free


def cell_field(sh: dict, seed: int) -> dict:
    """The cell's network as float32 numpy arrays from ``seed``: UEs ``U``
    (N, 3) and cells ``C`` (M, 3) uniform in a square of
    :data:`CELL_SPACING_M` * sqrt(M) a side, ``Pw`` (M, K) the power
    split over the subbands; the incremental cell adds ``idx``
    (max_moves,) distinct int32 rows and their new positions ``new_pos``."""
    N, M, K = sh["n_ues"], sh["n_cells"], sh["n_subbands"]
    rng = np.random.default_rng(seed)
    side = CELL_SPACING_M * np.sqrt(M)

    def drop(n, h):
        xy = rng.uniform(0.0, side, (n, 2)).astype(np.float32)
        return np.column_stack([xy, np.full((n, 1), h, np.float32)])

    field = dict(U=drop(N, H_UE), C=drop(M, H_BS),
                 Pw=np.full((M, K), POWER_W / K, np.float32))
    if sh["variant"] == "incremental":
        moves = sh["max_moves"]
        field["idx"] = rng.choice(N, moves, replace=False).astype(np.int32)
        field["new_pos"] = drop(moves, H_UE)
    return field


def make_step(variant: str, mesh, n_cells: int, k: int, tile: int = 0):
    """The step maker of ``variant`` on ``mesh`` for this network."""
    common = dict(mesh=mesh, pathgain_fn=make_pathloss(
        "power_law", alpha=ALPHA).get_pathgain, noise_w=NOISE_W,
        n_cells=n_cells, subband_bw=BANDWIDTH_HZ / k, fairness_p=0.0)
    if variant == "materialized":
        return D.make_materialized_step(**common)
    if variant == "streaming":
        return D.make_streaming_step(**common, cell_tile=tile)
    return D.make_incremental_rows_step(**common, cell_tile=tile)


def initial_state(step, U, C, Pw):
    """``(w, u, a, best_val)`` of every row: the incremental step over all
    N rows, from an empty state, moved to where they are."""
    n, k = U.shape[0], Pw.shape[1]
    zeros = torch.zeros((n, k), device=U.device)
    idx = torch.arange(n, dtype=torch.int32, device=U.device)
    _, w, u, a, bv, _ = step(U, C, Pw, zeros, zeros,
                             torch.zeros(n, dtype=torch.int32,
                                         device=U.device),
                             torch.full((n,), float("-inf"), device=U.device),
                             idx, U)
    return w, u, a, bv


def _timed(fn, device):
    """``(out, wall ms, device ms)`` of one synchronised call; the device
    time is CUDA events around the call, None on the CPU."""
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        end.record()
        torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) * 1e3
    return out, wall, start.elapsed_time(end) if on_card else None


def run_crrm_cell(shape_name: str, mesh, mesh_name: str, out_dir: str,
                  force: bool = False, seed: int = 0) -> tuple:
    """Run one crrm-ppp cell once on ``mesh`` and write its artifact.

    Returns ``(artifact, outputs)``: the step's outputs on the device
    (``(gamma, a, tput)``, or the incremental step's ``(U, w, u, a,
    best_val, tput)``), None when an artifact already on disk is returned
    without ``force``.
    """
    dev = mesh.device
    os.makedirs(f"{out_dir}/{mesh_name}/crrm-ppp", exist_ok=True)
    path = f"{out_dir}/{mesh_name}/crrm-ppp/{shape_name}.json"
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f), None
    sh = crrm_ppp.SHAPES[shape_name]
    N, M, K, variant = (sh["n_ues"], sh["n_cells"], sh["n_subbands"],
                        sh["variant"])
    plan = plan_cell(sh, budget_bytes(dev))
    field = cell_field(sh, seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = {name: torch.as_tensor(x, device=dev) for name, x in field.items()}
    step = make_step(variant, mesh, M, K, plan.get("cell_tile", 0))
    args = (t["U"], t["C"], t["Pw"])
    art = {"arch": "crrm-ppp", "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "n_ues": N, "n_cells": M, "n_subbands": K,
           "seed": seed, "backend": dev.type,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "n_devices": dist.get_world_size(), **plan}
    if variant == "incremental":
        setup = make_step(variant, mesh, M, K, plan["setup_tile"])
        state, wall, dms = _timed(lambda: initial_state(setup, *args), dev)
        art["setup"] = {"what": "(w, u, a, best_val) of every row: the "
                                "incremental step over all N rows",
                        "wall_ms": wall, "device_ms": dms}
        args = args + state + (t["idx"], t["new_pos"])
    with D.count_collectives() as coll:
        out, wall, dms = _timed(lambda: step(*args), dev)
    work, byts = analytic_counts(sh)
    art.update({"analytic_flops": work, "analytic_bytes": byts,
                "model_flops": work,
                "collective_wire_bytes": coll.total_wire_bytes,
                "collective_counts": dict(coll.counts),
                "wall_ms": wall, "device_ms": dms,
                "peak_bytes_per_device": (
                    torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None)})
    art["roofline_row"] = roofline.format_row(
        f"{mesh_name}/crrm-ppp/{shape_name}", art)
    with open(path, "w") as f:
        json.dump(art, f, indent=1, default=float)
    return art, out


@contextlib.contextmanager
def one_rank_group(device):
    """A 1-rank default process group in this process, destroyed on exit:
    NCCL on the card, gloo on the CPU, joined through a file store."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="dryrun-") as d:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            yield
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the LM cells: reckoned over the named meshes
# ---------------------------------------------------------------------------
#: the reference's HLO fields, which need its compiler
ABSENT = ("hlo_flops", "hlo_flops_per_device", "hlo_bytes",
          "hlo_bytes_per_device", "collective_wire_bytes",
          "collective_counts", "collective_bytes_by_kind",
          "memory_analysis", "compile_seconds")


def _param_counts(cfg) -> dict:
    """Total/active/non-embedding parameter counts from the meta init."""
    from repro_torch.models.registry import make_arch
    from repro_torch.tree import flatten
    keys, leaves = flatten(make_arch(cfg).init(torch.Generator(),
                                               device="meta"))
    total = emb = routed = 0
    for key, leaf in zip(keys, leaves):
        names = key.split("/")
        n = int(np.prod(leaf.shape))
        total += n
        if names[-1] in ("embedding", "kernel"):
            emb += n
        if ("moe" in names and names[-1] in ("wi_gate", "wi_up", "wo")
                and len(leaf.shape) >= 3):
            routed += n
    n_body = total - emb
    if cfg.n_experts:
        active = (n_body - routed
                  + routed * cfg.n_experts_per_token / cfg.n_experts)
    else:
        active = n_body
    return {"total": total, "non_embedding": n_body, "active": active}


def _model_flops(cfg, shape_name: str) -> float:
    from repro_torch.models.registry import SHAPES
    sh = SHAPES[shape_name]
    tokens = sh["global_batch"] * (1 if sh["kind"] == "decode"
                                   else sh["seq_len"])
    n_active = _param_counts(cfg)["active"]
    if sh["kind"] == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens   # fwd-only (prefill / decode)


def cell_plan(cfg, shape_name: str, mesh) -> dict:
    """The reference's ``_lower_cell`` choices: the strategy ("dp" --
    ZeRO-3 over every axis -- for train cells of <= 8B non-MoE,
    non-hybrid archs whose global batch covers the mesh, else "2d") and,
    for train cells, the microbatch accumulation."""
    from repro_torch.models.registry import SHAPES
    from repro_torch.parallel.mesh import mesh_size
    sh = SHAPES[shape_name]
    n_total = _param_counts(cfg)["total"]
    use_dp = (sh["kind"] == "train" and cfg.family not in ("moe", "hybrid")
              and n_total <= 8e9
              and sh["global_batch"] % mesh_size(mesh) == 0)
    plan = {"strategy": "dp" if use_dp else "2d"}
    if sh["kind"] == "train":
        plan["accum_steps"] = 4 if cfg.d_ff >= 24000 else (
            2 if (cfg.d_model >= 8192 or cfg.family in ("hybrid", "moe"))
            else 1)
    return plan


def reckon_cell_bytes(cfg, shape_name: str, mesh, strategy: str) -> dict:
    """Per-device bytes of a cell's state under ``strategy`` on ``mesh``,
    from the rules' spec trees: train cells the params and the state of
    ``adafactor`` (the reference's dry-run optimizer), serve cells the
    params in bfloat16 and the cache (a prefill writes one of the cell's
    length).  Meta tensors: nothing is allocated."""
    import dataclasses

    from repro_torch.models.registry import SHAPES, input_specs, make_arch
    from repro_torch.parallel import mesh as M
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optim
    sh = SHAPES[shape_name]
    prev = M.get_strategy()
    M.set_strategy(strategy)
    try:
        if sh["kind"] == "train":
            params = make_arch(cfg).init(torch.Generator(), device="meta")
            opt = optim.adafactor(optim.constant_lr(1e-4)).init(params)
            out = {"params": shd.per_device_bytes(
                params, shd.infer_param_specs(params, mesh), mesh),
                "opt": shd.per_device_bytes(
                    opt, shd.infer_param_specs(opt, mesh), mesh)}
        else:
            cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
            arch = make_arch(cfg)
            params = arch.init(torch.Generator(), device="meta")
            _, cache = input_specs(cfg, shape_name)
            if cache is None:       # prefill: the cache it writes
                S, B = sh["seq_len"], sh["global_batch"]
                cache = arch.init_cache(B, S, S, device="meta")
            out = {"params": shd.per_device_bytes(
                params, shd.infer_param_specs(params, mesh), mesh),
                "cache": shd.per_device_bytes(
                    cache, shd.cache_specs(cfg, cache, mesh), mesh)}
    finally:
        M.set_strategy(prev)
    out["total"] = sum(out.values())
    return out


def one_device_bytes(cfg, shape_name: str, strategy: str) -> dict:
    """:func:`reckon_cell_bytes` over a (1, 1) mesh, and for a train cell
    a floor under what its step adds (``step_floor``): the gradients (one
    float32 per param), the chunked CE's one live float32 logits chunk
    (B x min(512, S) x vocab) and one residual stream (B x S x d_model in
    the compute dtype)."""
    from repro_torch.models.registry import SHAPES
    from repro_torch.parallel.mesh import ShapeMesh
    out = reckon_cell_bytes(cfg, shape_name,
                            ShapeMesh((1, 1), ("data", "model")), strategy)
    sh = SHAPES[shape_name]
    if sh["kind"] == "train":
        B, S = sh["global_batch"], sh["seq_len"]
        cdt = 2 if cfg.dtype == "bfloat16" else 4
        out["step_floor"] = (4 * _param_counts(cfg)["total"]
                             + B * min(512, S) * cfg.vocab_size * 4
                             + B * S * cfg.d_model * cdt)
        out["total"] += out["step_floor"]
    return out


def run_lm_cell(arch_id: str, shape_name: str, mesh, mesh_name: str,
                out_dir: str, force: bool = False) -> dict:
    """Reckon one LM cell on ``mesh`` (a named ``ShapeMesh``) and write
    its artifact (see the module docstring)."""
    from repro_torch.analysis.flops import step_bytes, step_flops
    from repro_torch.models.registry import shape_applicable
    from repro_torch.parallel.mesh import mesh_size
    os.makedirs(f"{out_dir}/{mesh_name}/{arch_id}", exist_ok=True)
    path = f"{out_dir}/{mesh_name}/{arch_id}/{shape_name}.json"
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch_id)
    ok, reason = shape_applicable(cfg, shape_name)
    if not ok:
        art = {"skipped": True, "reason": reason, "arch": arch_id,
               "shape": shape_name, "mesh": mesh_name}
    else:
        counts = _param_counts(cfg)
        fl = step_flops(cfg, shape_name)
        by = step_bytes(cfg, shape_name, counts["total"])
        plan = cell_plan(cfg, shape_name, mesh)
        art = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
               "n_devices": mesh_size(mesh), **plan,
               "param_counts": counts, "analytic_flops": fl["total"],
               "analytic_flops_fwd": fl["fwd"],
               "analytic_bytes": by["total"],
               "analytic_bytes_breakdown": by,
               "model_flops": _model_flops(cfg, shape_name),
               "reckoned_bytes_per_device": reckon_cell_bytes(
                   cfg, shape_name, mesh, plan["strategy"]),
               "reckoned_bytes_one_device": one_device_bytes(
                   cfg, shape_name, plan["strategy"]),
               "absent": {"fields": list(ABSENT),
                          "why": "the reference reads them from the "
                                 "compiled HLO (analysis/hlo.py); the "
                                 "port compiles nothing"}}
    with open(path, "w") as f:
        json.dump(art, f, indent=1, default=float)
    return art


def _report_lm(arch_id, shape, mesh_name, art, t0):
    if art.get("skipped"):
        print(f"[dryrun] {mesh_name}/{arch_id}/{shape}: SKIP "
              f"({art['reason'][:60]})", flush=True)
        return
    per, one = (art["reckoned_bytes_per_device"]["total"],
                art["reckoned_bytes_one_device"]["total"])
    print(f"[dryrun] {mesh_name}/{arch_id}/{shape}: OK "
          f"strategy={art['strategy']} "
          f"flops={art['analytic_flops']:.3e} "
          f"model_flops={art['model_flops']:.3e} "
          f"bytes={art['analytic_bytes']:.3e} "
          f"reckoned={per / 2**30:.3f} GiB/dev ({one / 2**30:.1f} GiB on "
          f"one device) wall={time.perf_counter() - t0:.1f}s", flush=True)


def _report(shape, mesh_name, art, t0):
    peak = art.get("peak_bytes_per_device")
    dms = art.get("device_ms")
    print(f"[dryrun] {mesh_name}/crrm-ppp/{shape}: OK "
          f"flops={art['analytic_flops']:.3e} "
          f"bytes={art['analytic_bytes']:.3e} "
          f"peak={'-' if peak is None else f'{peak / 2**30:.2f} GiB'} "
          f"reckoned={art['reckoned_bytes'] / 2**30:.2f} GiB "
          f"device={'-' if dms is None else f'{dms:.1f} ms'} "
          f"wall={time.perf_counter() - t0:.1f}s", flush=True)
    for cut in art["reduced"]:
        print(f"[dryrun]   reduced: {cut}", flush=True)
    print(art["roofline_row"], flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="run the crrm-ppp cells once on one device; reckon the "
                    "LM cells over the named meshes")
    ap.add_argument("--arch", default=None,
                    choices=LM_ARCH_IDS + [crrm_ppp.ARCH_ID])
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "tiny", "tinypod"],
                    help="the named mesh of the LM cells")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on --mesh (or both prod "
                         "meshes with --both-meshes)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the crrm-ppp cells (default: the "
                         "card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    archs = ([args.arch] if args.arch else
             (LM_ARCH_IDS + [crrm_ppp.ARCH_ID] if args.all else []))
    for arch_id in archs:
        if arch_id == crrm_ppp.ARCH_ID:
            _crrm_cells(args)
        else:
            _lm_cells(arch_id, args)


def _lm_cells(arch_id, args):
    from repro_torch.launch.mesh import make_named_mesh
    from repro_torch.models.registry import SHAPES
    meshes = ["pod", "multipod"] if args.both_meshes else [args.mesh]
    for mesh_name in meshes:
        mesh = make_named_mesh(mesh_name)
        for s in [args.shape] if args.shape else list(SHAPES):
            t0 = time.perf_counter()
            art = run_lm_cell(arch_id, s, mesh, mesh_name, args.out,
                              args.force)
            _report_lm(arch_id, s, mesh_name, art, t0)


def _crrm_cells(args):
    dev = resolve_device(args.device)
    mesh_name = f"{dev.type}-1x1"
    shapes = [args.shape] if args.shape else list(crrm_ppp.SHAPES)
    with one_rank_group(dev):
        mesh = D.make_mesh((1, 1), ("data", "model"), dev)
        for s in shapes:
            t0 = time.perf_counter()
            art, _ = run_crrm_cell(s, mesh, mesh_name, args.out, args.force,
                                   args.seed)
            _report(s, mesh_name, art, t0)


if __name__ == "__main__":
    main()
