"""Self-healing harness: carry guards, watchdog policy, chaos drills.

The fault process (``sim.faults``) makes the *simulated network* fail on
purpose; this package makes the *serving process* survive failure -- its
own and the simulator's:

* :mod:`repro_torch.robust.guard` -- an invariant check over the episode
  carry (NaN-free, finite positions, non-negative queues and averages),
  one device reduction read back once, with a host diagnostic that names
  what broke.
* :mod:`repro_torch.robust.watchdog` -- the recovery policy
  (:class:`~repro_torch.robust.watchdog.WatchdogConfig`), the fault
  taxonomy (timeout, guard violation, the terminal
  :class:`~repro_torch.robust.watchdog.TwinServerDown`) and a thread-based
  chunk timeout.  ``twin.server.TwinServer`` rolls back to the last valid
  checkpoint and retries with exponential backoff by it.
* :mod:`repro_torch.robust.chaos` -- the chaos drill: a twin under a cell
  fault storm with an injected NaN, a crashing chunk and a corrupted
  latest checkpoint, asserting the server recovers on the route it was
  built with.
"""
from repro_torch.robust.guard import (carry_ok, carry_violations,
                                      nan_leaves, tree_has_nan)
from repro_torch.robust.watchdog import (ChunkTimeout, GuardViolation,
                                         TwinFault, TwinServerDown,
                                         WatchdogConfig, run_with_timeout)

__all__ = [
    "carry_ok", "carry_violations", "nan_leaves", "tree_has_nan",
    "WatchdogConfig", "TwinFault", "ChunkTimeout", "GuardViolation",
    "TwinServerDown", "run_with_timeout",
]
