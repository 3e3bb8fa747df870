"""The cell fault process: a per-cell UP/SLEEP/DOWN Markov chain.

Each cell walks

    UP --outage_rate_hz--> DOWN --1/mean_outage_s--> UP
    UP --sleep_rate_hz--> SLEEP --1/mean_sleep_s--> UP

once per TTI inside the engine (``mac.engine``, ``faults=``).  The process
acts only through the per-cell tx-power multiplier: DOWN is exactly 0.0
(a dark RSRP column: no UE attaches, the serving SINR collapses and the
ordinary radio chain reattaches), SLEEP attenuates by ``sleep_atten_db``,
UP is exactly 1.0.  The transition takes one uniform per cell, drawn by
``mac.engine.Draws.fault_uniform`` from a lineage of its own, so turning
faults on leaves every other stream untouched.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: cell fault states (int32 codes carried in ``EpisodeState.cell_state``)
UP, SLEEP, DOWN = 0, 1, 2


class FaultConfig(NamedTuple):
    """The per-cell Markov fault process parameters.

    Rates are per-cell Poisson intensities in events/second; dwell times
    are means of the geometric (per-TTI) holding distribution.  With
    ``tti_s`` the engine's TTI length, the per-TTI transition
    probabilities are ``rate * tti_s`` (entry) and ``tti_s / mean_s``
    (exit); ``CRRM_parameters`` checks that each stays at most 1.
    """

    #: UP -> DOWN transition intensity per cell (events/s); 0 = no outages
    outage_rate_hz: float = 0.0
    #: mean DOWN dwell (s) before the cell is repaired back to UP
    mean_outage_s: float = 0.05
    #: UP -> SLEEP transition intensity per cell (events/s); 0 = no sleeps
    sleep_rate_hz: float = 0.0
    #: mean SLEEP dwell (s) before the cell wakes back to UP
    mean_sleep_s: float = 0.05
    #: tx power attenuation while SLEEPing, in dB (soft degradation)
    sleep_atten_db: float = 10.0


def init_cell_state(n_cells: int, device="cpu"):
    """The all-UP initial per-cell fault state (int32 codes)."""
    return torch.zeros((n_cells,), dtype=torch.int32, device=device)


def fault_step(u, cell_state, tti_s: float, cfg: FaultConfig):
    """One TTI of every cell's chain: ``(new_state, changed)``.

    ``u`` is the TTI's (n_cells,) uniform draw; the thresholds are Python
    constants, so the step is a handful of selects.  ``changed`` flags the
    cells whose state moved (the incremental path's dirty-cell mask).
    """
    p_down = cfg.outage_rate_hz * tti_s
    p_sleep = cfg.sleep_rate_hz * tti_s
    p_repair = tti_s / cfg.mean_outage_s if cfg.mean_outage_s > 0 else 1.0
    p_wake = tti_s / cfg.mean_sleep_s if cfg.mean_sleep_s > 0 else 1.0
    from_up = torch.where(u < p_down, DOWN,
                          torch.where(u < p_down + p_sleep, SLEEP, UP))
    from_down = torch.where(u < p_repair, UP, DOWN)
    from_sleep = torch.where(u < p_wake, UP, SLEEP)
    new = torch.where(cell_state == DOWN, from_down,
                      torch.where(cell_state == SLEEP, from_sleep, from_up))
    new = new.to(torch.int32)
    return new, new != cell_state


def tx_multiplier(cell_state, cfg: FaultConfig):
    """Per-cell linear tx-power multiplier: UP 1.0, SLEEP
    ``10^(-sleep_atten_db/10)``, DOWN exactly 0.0 (float32)."""
    atten = 10.0 ** (-cfg.sleep_atten_db / 10.0)
    return torch.where(cell_state == DOWN, 0.0,
                       torch.where(cell_state == SLEEP, atten, 1.0)
                       ).to(torch.float32)
