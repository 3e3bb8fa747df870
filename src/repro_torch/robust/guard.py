"""Invariant guard over the episode carry.

A digital twin that serves for hours will meet a state its authors never
rolled: a pathological control update, a numerical edge of the SINR
chain, a bad checkpoint.  The failure that matters is the silent one -- a
NaN born in one TTI spreads through every EWMA and backlog it touches
while the twin streams garbage KPIs.  This module is the tripwire: one
device reduction over the whole :class:`~repro_torch.mac.engine.
EpisodeState` that the twin server checks once per chunk, read back once.

Invariants checked (:func:`carry_ok`):

* no float leaf anywhere in the carry holds NaN;
* UE positions ``U`` are finite;
* the PF average ``pf_avg`` and pending HARQ bits ``harq_bits`` are finite
  and non-negative;
* ``backlog`` is non-negative -- ``+inf`` is legal there (the engine's
  full-buffer sentinel), which is why the guard is NaN-centric rather
  than a blanket ``isfinite``;
* the TTI counter ``t`` is non-negative.

:func:`carry_violations` is the host post-mortem: slow, per leaf, and it
names which invariant broke where -- what the watchdog records when a
chunk fails.  :func:`tree_has_nan` and :func:`nan_leaves` are the
checkpoint layer's refusal check for any tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import flatten


def _verdict(flags) -> bool:
    """``all(flags)`` of 0-dim device bools: stacked, read back once."""
    if not flags:
        return True
    dev = flags[0].device
    return bool(torch.stack([f.to(dev) for f in flags]).all().item())


def nan_leaves(keys, leaves) -> list:
    """The keys of the float leaves that hold a NaN (``+inf`` does not
    count): one ``isnan().any()`` per tensor leaf, stacked and read back
    once."""
    tensor_keys, flags, bad = [], [], []
    for k, x in zip(keys, leaves):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                tensor_keys.append(k)
                flags.append(torch.isnan(x).any())
        else:
            arr = np.asarray(x)
            if np.issubdtype(arr.dtype, np.floating) and np.isnan(arr).any():
                bad.append(k)
    if flags:
        dev = flags[0].device
        hit = torch.stack([f.to(dev) for f in flags]).tolist()
        bad += [k for k, h in zip(tensor_keys, hit) if h]
    return bad


def tree_has_nan(tree) -> bool:
    """True iff any float leaf of ``tree`` holds NaN.  ``+inf``/``-inf``
    do not trip it: ``+inf`` is the full-buffer backlog sentinel."""
    return bool(nan_leaves(*flatten(tree)))


def carry_ok(state) -> bool:
    """The episode carry satisfies every engine invariant.

    One reduction per invariant and float leaf, all stacked on the device
    and read back with one ``.item()``.  The reductions span every axis, so
    a batched carry (leaves leading with B) passes only when every env
    does: a twin never serves a half-poisoned batch.
    """
    flags = [~torch.isnan(x).any() for x in flatten(state)[1]
             if isinstance(x, torch.Tensor) and x.is_floating_point()]
    flags += [
        torch.isfinite(state.U).all(),
        (torch.isfinite(state.pf_avg) & (state.pf_avg >= 0)).all(),
        (torch.isfinite(state.harq_bits) & (state.harq_bits >= 0)).all(),
        (state.backlog >= 0).all(),        # +inf legal: full-buffer sentinel
        (state.t >= 0).all(),
    ]
    return _verdict(flags)


def carry_violations(state) -> list:
    """Host diagnostic: one line per broken invariant (empty: clean).

    The slow path -- every leaf comes to the host -- run only after
    :func:`carry_ok` said the carry is bad, to build the watchdog's
    failure report.
    """
    out = []
    for key, leaf in zip(*flatten(state)):
        x = np.asarray(_host(leaf))
        if np.issubdtype(x.dtype, np.floating) and np.isnan(x).any():
            out.append("%s: %d NaN values" % (key, int(np.isnan(x).sum())))

    def check(name, cond, what):
        x = np.asarray(_host(getattr(state, name)))
        bad = ~cond(x)
        if bad.any():
            out.append("%s: %d values %s" % (name, int(bad.sum()), what))

    check("U", np.isfinite, "not finite")
    check("pf_avg", lambda x: np.isfinite(x) & (x >= 0),
          "not finite and non-negative")
    check("harq_bits", lambda x: np.isfinite(x) & (x >= 0),
          "not finite and non-negative")
    check("backlog", lambda x: ~np.isnan(x) & (x >= 0), "negative or NaN")
    check("t", lambda x: x >= 0, "negative")
    return out


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x
