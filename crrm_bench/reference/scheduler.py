"""Per-cell resource-block allocation policies (single device).

A cell owns ``n_rb`` resource blocks per frequency chunk per TTI.  A policy
maps (``se``, ``cqi``, attachment ``a``) plus MAC state (``active`` mask,
PF weights, round-robin cursor) to ``alloc[i, k]``, the RBs granted to UE
``i`` on chunk ``k``:

* ``rr``       -- active attached UEs split the grid evenly; the integer
  remainder rotates with a per-TTI cursor;
* ``max_cqi``  -- the best-CQI active UE takes the cell's whole grid (ties
  to the lowest UE index);
* ``pf``       -- RBs split in proportion to the alpha-fair weight.

A frozen copy of the program's plain scheduler on one device, without its
mesh, batch-relaxation and soft paths.
"""
from __future__ import annotations

import numpy as np
import torch

from . import segments

SCHEDULER_POLICIES = ("rr", "max_cqi", "pf")

#: cap on the alpha-fair exponent (singular at fairness_p = 1)
_ALPHA_MAX = 63.0
#: finite stand-in for -inf as the idle weight: exp(_NEG - m) underflows
#: to exactly 0.0, with a zero gradient where -inf - -inf would put a NaN
#: into the backward pass
_NEG = -1e30
#: floor of the share's denominator: never reached forward (a nonempty
#: cell's peak weight is exp(0) = 1), and its square, which the backward
#: pass forms, stays a normal float32
_DENOM_FLOOR = 1e-15


def _cell_mask(active, a, n_cells):
    """M[..., i, j, k] = UE i is active on subband k and attached to j."""
    cells = torch.arange(n_cells, device=a.device)
    onehot = a.long()[..., None] == cells
    return active[..., :, None, :] & onehot[..., None]


def allocate_rr(active, a, n_cells, n_rb, cursor):
    """Round-robin: even integer split, remainder rotated by ``cursor``.

    A UE's within-cell rank comes from one stable sort by cell plus prefix
    sums; the stable sort keeps each cell's UEs in index order.
    """
    a = a.long()
    act_i = active.to(torch.int32)                     # (..., n_ue, K)
    counts = segments.segment_sum(act_i, a, n_cells)   # (..., n_cells, K)
    order = torch.sort(a, dim=-1, stable=True).indices
    by_row = order[..., None].expand_as(act_i)
    csum = torch.cumsum(torch.gather(act_i, -2, by_row), dim=-2,
                        dtype=torch.int32)
    offs = torch.cumsum(counts, dim=-2, dtype=torch.int32) - counts
    rank_sorted = csum - 1 - segments.take(offs, torch.gather(a, -1, order))
    rank = torch.empty_like(rank_sorted).scatter_(-2, by_row, rank_sorted)
    n_act = torch.clamp(segments.take(counts, a), min=1)
    nrb = torch.full_like(n_act, n_rb)
    base = torch.div(nrb, n_act, rounding_mode="floor")
    if isinstance(cursor, torch.Tensor) and cursor.dim():
        cursor = cursor[:, None, None]                 # one per env
    # floor-mod (torch.remainder), as jnp's %, never torch.fmod
    extra = torch.remainder(rank - cursor, n_act) < torch.remainder(nrb, n_act)
    return torch.where(active, (base + extra).to(torch.float32), 0.0)


def allocate_max_cqi(active, cqi, a, n_cells, n_rb):
    """Winner-take-all: the best-CQI active UE gets the cell's whole grid,
    ties to the lowest UE index."""
    M = _cell_mask(active, a, n_cells)
    score = torch.where(M, cqi[..., :, None, :], -1)    # (..., n_ue, cells, K)
    n = active.shape[-2]
    i = torch.arange(n, device=active.device)[:, None]
    winner = torch.argmax(score, dim=-3)                # first max: lowest UE
    mine = segments.take(winner, a)                     # (..., n_ue, K)
    return torch.where(active & (mine == i), float(n_rb), 0.0)


def _softmax_share(active, log_w, a, n_cells):
    """Each active UE's share of its cell, ``softmax(log_w)`` over the
    cell's active UEs (0 for idle UEs and empty cells)."""
    log_w = torch.where(active, log_w, _NEG)
    cell_max = segments.segment_max(log_w, a, n_cells, fill=_NEG)
    w = torch.exp(log_w - segments.take(cell_max, a))   # in (0, 1], 0 if idle
    w = torch.where(active, w, 0.0)
    denom = segments.segment_sum(w, a, n_cells)
    denom = segments.take(denom, a)
    return torch.where(denom > 0.0,
                       w / torch.clamp(denom, min=_DENOM_FLOOR), 0.0)


def allocate_pf(active, log_w, a, n_cells, n_rb):
    """Weight-proportional split of the grid (log-space for stability)."""
    return n_rb * _softmax_share(active, log_w, a, n_cells)


def allocate(policy, active, cqi, a, n_cells, n_rb, cursor, log_w):
    """Dispatch to a policy.  ``log_w`` carries the PF weights; the other
    policies ignore it."""
    if policy == "rr":
        return allocate_rr(active, a, n_cells, n_rb, cursor)
    if policy == "max_cqi":
        return allocate_max_cqi(active, cqi, a, n_cells, n_rb)
    if policy == "pf":
        return allocate_pf(active, log_w, a, n_cells, n_rb)
    raise ValueError(
        f"unknown scheduler policy {policy!r}; choose from "
        f"{SCHEDULER_POLICIES}")


def pf_log_weights_stationary(se, fairness_p):
    """log(se**-p): the alpha-fair stationary weights (legacy allocation)."""
    return -fairness_p * torch.log(torch.clamp(se, min=1e-12))


def pf_alpha(fairness_p):
    """The alpha-fair exponent (1+p)/(1-p), capped, rounded in float32.

    A Python float (the params' constant) is rounded once per operand, as
    the reference folds a baked constant; a tensor (a per-call override) is
    computed in float32 arithmetic, as the reference computes a traced one.
    """
    if isinstance(fairness_p, torch.Tensor):
        fp = fairness_p.to(torch.float32)
        return torch.clamp((1.0 + fp) / torch.clamp(1.0 - fp, min=1e-6),
                           max=_ALPHA_MAX)
    f32 = np.float32
    return float(np.minimum(f32(1.0 + fairness_p)
                            / np.maximum(f32(1.0 - fairness_p), f32(1e-6)),
                            f32(_ALPHA_MAX)))


def pf_log_weights_ewma(rate, avg, fairness_p):
    """log(rate / avg**alpha): the temporal PF metric over EWMA throughput.
    A (B,) ``fairness_p`` holds one exponent per env of a batch."""
    alpha = pf_alpha(fairness_p)
    if isinstance(alpha, torch.Tensor) and alpha.dim():
        alpha = alpha[:, None, None]
    return (torch.log(torch.clamp(rate, min=1e-12))
            - alpha * torch.log(torch.clamp(avg, min=1e-3)))


def served_bits(alloc, se, backlog, rb_bw_hz, tti_s, floor=1e-30):
    """Bits drained per (UE, subband) in one TTI: grant capacity, capped by
    the UE's total backlog (``inf - bits`` stays ``inf`` for full buffer).

    ``floor`` guards the backlog/grant ratio: 1e-30 is forward-exact; the
    relaxed engine passes 1e-6 bits, since the backward pass squares the
    grant total and a soft grant of ~1e-25 bits would underflow to 0."""
    cap = alloc * rb_bw_hz * se * tti_s                # (..., n_ue, K) bits
    tot = cap.sum(dim=-1)
    scale = torch.where(tot > 0.0,
                        torch.clamp(backlog / torch.clamp(tot, min=floor),
                                    max=1.0),
                        0.0)
    return cap * scale[..., None]
