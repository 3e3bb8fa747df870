"""UE mobility: bounded random walks, the exact-count window movers, and
the birth-death UE process.

:class:`ChurnConfig` and :func:`birth_death_step` are the digital twin's
churn: over a capacity-padded ``active`` mask, UEs depart with
exponential lifetimes and arrive (Poisson) into the lowest free slots.
The step takes its draws as tensors (``mac.engine.Draws.churn_birth`` /
``churn_death``), so replayed draws reproduce the reference exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ChurnConfig(NamedTuple):
    """The birth-death process parameters.

    The UE axis is *capacity-padded*: ``n_ues`` is the slot capacity, the
    live population the ``active`` mask's popcount.  Stationary mean
    occupancy is ``arrival_rate_hz * mean_lifetime_s`` (M/M/inf); arrivals
    beyond free capacity are dropped.
    """

    arrival_rate_hz: float        # Poisson arrival intensity, UEs/second
    mean_lifetime_s: float        # exponential lifetime -> per-TTI departure
    max_arrivals_per_tti: int     # static cap = the birth dirty-row budget
    newborn_backlog_bits: float = 0.0   # seed backlog (inf = full buffer)


def churn_rates(tti_s: float, churn: ChurnConfig):
    """``(p_depart, lam)``: each active UE's per-TTI departure probability
    and the Poisson mean of the per-TTI arrivals."""
    return (min(1.0, tti_s / churn.mean_lifetime_s),
            churn.arrival_rate_hz * tti_s)


def birth_death_step(n_poisson, depart, active, churn: ChurnConfig):
    """One TTI of the birth-death process over the capacity-padded mask.

    ``depart`` is the (n,) Bernoulli(``p_depart``) draw and ``n_poisson``
    the 0-dim Poisson(``lam``) draw of :func:`churn_rates`.  Departures
    first (only active slots leave), then ``min(n_poisson,
    max_arrivals_per_tti, free slots)`` newborns take the lowest-index free
    slots by a cumsum rank.  Returns ``(active, born, n_born)``: the updated
    mask, the newborn mask and its int32 popcount; no host read.
    """
    active = active & ~(depart & active)
    n_arrive = torch.clamp(n_poisson, max=churn.max_arrivals_per_tti).to(
        torch.int32)
    free = ~active
    free_rank = torch.cumsum(free.to(torch.int32), dim=-1) - 1
    born = free & (free_rank < n_arrive[..., None])
    return active | born, born, born.sum(dim=-1).to(torch.int32)


def walk_steps(gen: torch.Generator, n: int, step_m: float):
    """Draw ``n`` uniform random-walk displacements in [-step_m, step_m)^2."""
    u = torch.rand((n, 2), generator=gen, device=gen.device)
    return u * (2.0 * step_m) - step_m


def apply_walk(positions, d, extent_m: float):
    """Displace every position by ``d``, clamped at the region borders."""
    new_xy = torch.clamp(positions[:, :2] + d, 0.0, extent_m)
    return torch.cat([new_xy, positions[:, 2:3]], dim=1)


def window_movers(gen: torch.Generator, n: int, n_move: int, step_m: float):
    """Exact-count mover selection: a random-offset circular index window.

    Movers are ``[start, start + n_move) mod n`` at a uniform ``start``.
    Returns ``(start, d)``: a 0-dim int64 tensor on the generator's device
    (no host sync) and the (n_move, 2) displacement draws.
    """
    start = torch.randint(0, n, (), generator=gen, device=gen.device)
    return start, walk_steps(gen, n_move, step_m)


def window_displacements(start, d, rows, n: int):
    """Per-row displacement + mover mask for the window-mover convention.

    Row r is a mover iff ``(r - start) mod n < n_move`` and then takes draw
    ``d[(r - start) mod n]``; non-movers get a zero displacement.
    """
    n_move = d.shape[0]
    j = torch.remainder(rows - start, n)
    moved = j < n_move
    dj = d[torch.clamp(j, 0, n_move - 1)]
    return torch.where(moved[:, None], dj, 0.0), moved
