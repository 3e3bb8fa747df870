"""What every entry kind shares.

An entry kind is a file of its own, ``entries/<kind>.py``, named by a
traffic file's ``"entry"`` and found by that name
(:func:`crrm_bench.harness.manifest.entry_kind`).  The file provides

* ``Entry``, a subclass of :class:`Base`, which builds the program from the
  cell's files and the seed (the configuration's ``CRRM_parameters``,
  updated by the traffic file's ``params``; ``setup``), warms up the shapes
  the window uses (``warmup``), runs one window call (``call``), and after
  the window hands the outputs that ``correct`` judges
  (``program_outputs``) together with what the plain reference computes in
  their place (``reference_outputs``);
* ``numbers(prog, ref)``, the numbers that ``correct`` compares, built from
  the general comparisons of :mod:`crrm_bench.harness.check`.

A kind whose ``Entry`` sets ``spans_ranks`` runs on every rank of a cell
over several (``harness/ranks.py``): it is built with ``ranks``, a
:class:`crrm_bench.harness.ranks.RankContext`, and rank 0's
``program_outputs`` are judged.  Every other kind gets ``ranks=None``.

A later benchmark adds a kind by adding such a file.
"""
from __future__ import annotations

import torch

_LEAVES = ("U", "backlog", "pf_avg", "rr_cursor", "harq_bits", "harq_retx",
           "serving", "ttt", "t", "active", "fad", "cell_state")


def leaves(state) -> dict:
    """The episode leaves of a program state (an ``EpisodeState``), as
    detached clones; the seed is not one of them."""
    return {k: getattr(state, k).detach().clone() for k in _LEAVES
            if getattr(state, k) is not None}


def start(static, state) -> dict:
    """What the program's set-up derived, for the start check."""
    return {"U": state.U.clone(), "a": static.a.clone(),
            "cqi": static.cqi.clone(), "pf_avg": state.pf_avg.clone()}


def ref_start(su) -> dict:
    """The same, as the reference's own set-up derives it."""
    return {"U": su.U, "a": su.a, "cqi": su.cqi, "pf_avg": su.pf_avg}


class Base:
    spans_ranks = False

    def __init__(self, cell, seed: int, device, ranks=None):
        self.seed = int(seed)
        self.ranks = ranks
        self.device = torch.device(device)
        self.traffic = cell.traffic
        self.params = dict(cell.config["CRRM_parameters"],
                           **self.traffic.get("params", {}), seed=self.seed)
        self.bad = torch.zeros((), dtype=torch.int64, device=self.device)
        self.tti_per_call = int(self.traffic["tti_per_call"])

    def _finite(self, x):
        self.bad += (~torch.isfinite(x).all()).to(torch.int64)

    def failed(self) -> int:
        return int(self.bad)

    def ttis(self, calls: int) -> int:
        return calls * self.tti_per_call

    def dirty_rows(self, calls: int) -> float:
        """Rows through the radio update in ``calls`` window calls: the
        window movers of every TTI."""
        n, frac = self.params["n_ues"], self.params.get("mobility_move_frac")
        n = n if frac is None else max(1, int(round(frac * n)))
        return float(n * self.ttis(calls))

    def route(self) -> dict:
        """Which rows route the program took, and why not the kernel."""
        return {"inc_backend": self.fns.inc_backend,
                "inc_reason": self.fns.inc_reason}

    def warmup(self):
        for _ in range(int(self.traffic.get("warmup_calls", 1))):
            self.call()

    def close(self):
        pass
