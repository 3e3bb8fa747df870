"""Per-TTI KPI telemetry: the :class:`Telemetry` tuple and its reducers.

A frozen copy of the program's plain telemetry on one device, without its
mesh reductions.  One :class:`Telemetry` per TTI (:func:`tti_telemetry`);
KPIs are computed only from values the step already produced.

Optional leaves are ``None`` where a regime cannot produce them:
``dirty_rows`` exists only in ``radio_mode="incremental"``, ``active_ues``
only under churn (the UE axis is then capacity-padded, and Jain's index
counts the live population), ``cells_down`` and ``reattach_events`` only
under faults.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from . import segments


class Telemetry(NamedTuple):
    """Per-TTI KPIs of one engine step (stacked to (n_tti, ...) by
    ``rollout``).  Cell-indexed tensors are aggregated over the *serving*
    attachment of the TTI; scalar counters are network-wide totals."""

    served_bits: Any    # (n_cells,) f32 bits delivered per serving cell
    granted_rb: Any     # (n_cells,) f32 resource blocks granted per cell
    harq_acks: Any      # i32 transport blocks delivered this TTI
    harq_nacks: Any     # i32 failed HARQ attempts this TTI
    harq_retx: Any      # i32 retransmission attempts this TTI
    dropped_bits: Any   # f32 TB bits dropped at harq_max_retx exhaustion
    ho_events: Any      # i32 A3 handovers fired this TTI
    buffer_bits: Any    # f32 total finite backlog after the TTI
    jain: Any           # f32 Jain fairness of per-UE delivered throughput
    dirty_rows: Any     # i32 radio rows recomputed | None (dense modes)
    active_ues: Any = None       # i32 live UEs | None (no churn)
    cells_down: Any = None       # i32 cells in outage | None (no faults)
    reattach_events: Any = None  # i32 serving changes | None (no faults)


def tti_telemetry(n_cells: int, n_ues: int, a, alloc, bits, tput, backlog,
                  harq_stats, ho_events, n_dirty,
                  active_count=None, cells_down=None,
                  reattached=None) -> Telemetry:
    """Assemble one TTI's :class:`Telemetry` from step intermediates.

    Reads the serving attachment ``a``, the allocation matrix, the
    delivered ``bits``/``tput`` and the post-drain ``backlog``;
    ``harq_stats`` is ``(acks, nacks, retx, dropped_bits)``.  Jain's
    fairness index over the per-UE delivered throughput is
    ``(sum x)^2 / (n * sum x^2)``, 0.0 for an idle TTI, with ``n`` the
    live population ``active_count`` under churn.  ``cells_down`` and
    ``reattached`` are the fault process's counts, published as given.
    Every input may lead with a batch axis.
    """
    acks, nacks, retx, dropped = harq_stats
    served = segments.segment_sum(bits.to(torch.float32), a, n_cells)
    granted = segments.segment_sum(alloc.sum(dim=-1).to(torch.float32), a,
                                   n_cells)
    occupancy = torch.where(torch.isfinite(backlog), backlog,
                            0.0).sum(dim=-1)
    s = tput.sum(dim=-1)
    ss = (tput * tput).sum(dim=-1)
    denom = (n_ues if active_count is None
             else torch.clamp(active_count, min=1))
    jain = torch.where(ss > 0.0, s * s / (denom * ss), 0.0)
    return Telemetry(served_bits=served, granted_rb=granted,
                     harq_acks=acks, harq_nacks=nacks, harq_retx=retx,
                     dropped_bits=dropped, ho_events=ho_events,
                     buffer_bits=occupancy, jain=jain, dirty_rows=n_dirty,
                     active_ues=active_count, cells_down=cells_down,
                     reattach_events=reattached)


def stack(telems, dim: int = 0) -> Telemetry:
    """Stack a sequence of per-TTI :class:`Telemetry` leaf by leaf to
    ``(n_tti, ...)`` (``dim=1``: to ``(B, n_tti, ...)`` for a batch);
    ``None`` leaves stay ``None``."""
    return Telemetry(*(None if leaves[0] is None
                       else torch.stack(leaves, dim=dim)
                       for leaves in zip(*telems)))


def _host(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def summarize(telem: Telemetry, tti_s: float | None = None) -> dict:
    """Reduce a telemetry stack to a flat dict of python-float KPIs.

    Accepts per-TTI stacks of any leading shape -- a rollout's
    ``(n_tti, ...)``, a batch's ``(B, n_tti, ...)`` or a single step --
    and aggregates over all leading axes.  ``tti_s`` converts the served-bits total into the busiest
    cell's mean rate (Mbit/s).
    """
    t = Telemetry(*(_host(x) for x in telem))
    n_tti = max(1, int(np.prod(t.jain.shape))) if t.jain.ndim else 1
    attempts = float(t.harq_acks.sum() + t.harq_nacks.sum())
    out = {
        "served_mbits": float(t.served_bits.sum()) / 1e6,
        "mean_cell_load_rb": float(t.granted_rb.mean()),
        "harq_acks": float(t.harq_acks.sum()),
        "harq_nacks": float(t.harq_nacks.sum()),
        "harq_nack_rate": (float(t.harq_nacks.sum()) / attempts
                           if attempts else 0.0),
        "harq_retx": float(t.harq_retx.sum()),
        "dropped_mbits": float(t.dropped_bits.sum()) / 1e6,
        "ho_events": float(t.ho_events.sum()),
        "mean_buffer_mbits": float(t.buffer_bits.mean()) / 1e6,
        "mean_jain": float(t.jain.mean()),
    }
    if tti_s is not None:
        busiest = t.served_bits.sum(axis=tuple(range(t.served_bits.ndim - 1)))
        out["busiest_cell_mbps"] = float(busiest.max()) / (n_tti * tti_s) / 1e6
    if t.dirty_rows is not None:
        out["mean_dirty_rows"] = float(t.dirty_rows.mean())
    if t.active_ues is not None:
        out["mean_active_ues"] = float(t.active_ues.mean())
    if t.cells_down is not None:
        out["mean_cells_down"] = float(t.cells_down.mean())
    if t.reattach_events is not None:
        out["reattach_events"] = float(t.reattach_events.sum())
    return out
