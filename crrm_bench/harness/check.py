"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to the limit of ``limits/<workload>.json``.
Each entry kind (``entries/<kind>.py``) builds its numbers from these.

Start (the program's set-up against the reference's own set-up from the
seed):

* ``start_rows_off``    -- UEs whose initial position (by more than
  :data:`POS_TOL_M`), attachment or CQI differs, or whose stationary PF
  average differs by more than :data:`RTOL`.

The judged call (the reference follows it from the program's input state):

* ``state_off``         -- elements of the carried state that differ, of
  every leaf but the floating-point ones: positions (by more than
  :data:`POS_TOL_M`), the TTI counter, the round-robin cursor, the HARQ
  retransmission counts, the A3 time-to-trigger counters, the serving
  cells (unless compared apart), the fault codes (faults) and the live
  flags (churn); for an env step every leaf of the returned state (floats
  by more than :data:`RTOL`; after a reset, the fresh episode), the
  observed backlog and ``done``;
* ``<leaf>_off_share``  -- for each floating-point leaf of the carried
  state but the positions (``pf_avg``, ``backlog``, ``harq_bits``, and
  ``fad`` under churn), the share of its elements that differ by more than
  :data:`RTOL` (every one where the program has no such leaf);
* ``tput_off_share``    -- share of the (TTI, UE) throughputs that differ
  by more than :data:`RTOL` of the reference's value (plus 1e-3 bit/s);
* ``serving_off``       -- UEs whose serving cell differs (faults);
* ``kpi_rel_gap``       -- largest relative gap of a KPI of the chunk's
  summary (twin);
* ``obs_off_share``, ``reward_gap``, ``telem_rel_gap`` -- an env step's
  observed throughput (the share of UEs off by more than RTOL), reward
  and telemetry sums, the worst of the judged steps (env).
"""
from __future__ import annotations

import math

import torch

RTOL = 1e-4
ATOL_BPS = 1e-3
POS_TOL_M = 1e-3


def f64(x):
    return x.detach().to(torch.float64)


def off(p, r):
    """Elements of ``p`` that differ from ``r`` by more than RTOL."""
    p, r = f64(p), f64(r)
    same = (p == r) | ((p - r).abs() <= RTOL * r.abs() + ATOL_BPS)
    return ~same


def off_share(p, r) -> float:
    """Share of the elements of ``p`` off from ``r``; 1 where the program
    has no such leaf or another shape."""
    if p is None or p.shape != r.shape:
        return 1.0
    return float(off(p, r).double().mean())


def count_off(p, r) -> float:
    """Elements that differ; every one where the program has no such leaf
    or another shape."""
    if p is None or p.shape != r.shape:
        return float(r.numel())
    return float((p != r).sum())


def pos_off(p, r):
    """Rows of positions that differ by more than POS_TOL_M."""
    return ((f64(p) - f64(r)).abs() > POS_TOL_M).reshape(
        p.shape[0], -1).any(1)


def start_numbers(p: dict, r: dict) -> dict:
    rows = (pos_off(p["U"], r["U"]) | (p["a"] != r["a"])
            | (p["cqi"] != r["cqi"]).reshape(p["cqi"].shape[0], -1).any(1)
            | off(p["pf_avg"], r["pf_avg"]))
    return {"start_rows_off": float(rows.sum())}


def state_numbers(ps: dict, rs: dict, apart=()) -> dict:
    """``state_off`` and a ``<leaf>_off_share`` per floating-point leaf,
    over every leaf of the reference's carried state ``rs`` but those
    compared ``apart``."""
    n_off = float(pos_off(ps["U"], rs["U"]).sum())
    out = {}
    for k, v in rs.items():
        if k == "U" or k in apart:
            continue
        if v.is_floating_point():
            out[f"{k}_off_share"] = off_share(ps.get(k), v)
        else:
            n_off += count_off(ps.get(k), v)
    out["state_off"] = n_off
    return out


def rel_gap(p: float, r: float) -> float:
    if p == r:
        return 0.0
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), 1e-12)


def verdict(nums: dict, limits: dict):
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit; a number with no limit, or a limit with no number, fails."""
    rows, ok = [], True
    for name in sorted(set(nums) | set(limits)):
        v = nums.get(name, math.nan)
        lim = limits.get(name, {}).get("limit", math.nan)
        good = v <= lim           # NaN compares False
        ok = ok and good
        rows.append((name, v, lim))
    return ok, rows
