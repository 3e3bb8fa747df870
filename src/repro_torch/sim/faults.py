"""The cell fault process's configuration: :class:`FaultConfig`.

A copy of ``repro.sim.faults.FaultConfig`` (fields and defaults), so that
``CRRM_parameters(faults=...)`` and the scenario registry are whole.  The
process itself -- each cell walking a per-TTI UP/SLEEP/DOWN Markov chain
that masks its tx power -- waits for the faults slice of the port:
anything that would run it (``CRRM``, ``episode_fns``, ``CrrmEnv``) raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple


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
