"""UE mobility: bounded random walks and the exact-count window movers.

The birth-death churn process of ``repro.sim.mobility`` waits for the
churn slice of the port.
"""
from __future__ import annotations

import torch


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
