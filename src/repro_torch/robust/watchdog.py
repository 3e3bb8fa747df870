"""Watchdog policy: the twin server's recovery contract, as data.

Recovery behaviour belongs in one config, not in scattered constants: the
same :class:`WatchdogConfig` a production twin runs with is what the chaos
drill (``repro_torch.robust.chaos``) and the tests shrink.
``twin.server.TwinServer`` runs its guarded serving loop by it:

1. run one chunk (optionally under :func:`run_with_timeout`);
2. check the carry with ``robust.guard.carry_ok``;
3. on success, checkpoint every ``ckpt_every_chunks`` chunks;
4. on *any* failure -- :class:`ChunkTimeout`, :class:`GuardViolation`, or
   an exception raised by the chunk -- roll back to the newest checkpoint
   that still validates (``train.checkpoint.restore_latest_valid``), sleep
   an exponentially growing delay and retry on the *same* route: the
   incremental backend is never switched (the reference's ``pallas ->
   xla`` degradation would hide a failing kernel);
5. after ``max_retries`` failed retries, or a rollback that itself fails,
   stop gracefully with :class:`TwinServerDown` carrying the failure
   history.

Rollback plus per-TTI draws keyed on the absolute TTI mean a successful
retry resumes on the uninterrupted trajectory: recovery re-runs lost work
and perturbs nothing.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional


class WatchdogConfig(NamedTuple):
    """Recovery policy of a guarded :class:`~repro_torch.twin.server.
    TwinServer`.

    ``max_retries`` bounds *consecutive* failed chunks: each successful
    chunk resets the budget.  ``backoff_s`` is the sleep before the first
    retry, multiplied by ``backoff_factor`` per later attempt.
    ``chunk_timeout_s`` arms the wall-clock watchdog on each chunk (None =
    never time out).  ``ckpt_every_chunks`` is the checkpoint cadence --
    also the most work a rollback can lose.
    """

    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    chunk_timeout_s: Optional[float] = None
    ckpt_every_chunks: int = 1


class TwinFault(RuntimeError):
    """Base of the per-chunk failures the watchdog itself detects."""


class ChunkTimeout(TwinFault):
    """A chunk exceeded ``WatchdogConfig.chunk_timeout_s`` wall-clock."""


class GuardViolation(TwinFault):
    """The post-chunk carry failed ``robust.guard.carry_ok``."""


class TwinServerDown(RuntimeError):
    """Terminal: recovery exhausted ``max_retries`` consecutive attempts,
    or a rollback failed.

    ``history`` is the chronological list of failure lines (one per failed
    attempt, each naming the route, and the rollback targets) -- the
    diagnostic a graceful stop hands to the operator.
    """

    def __init__(self, message: str, history=None):
        super().__init__(message)
        self.history = list(history or [])

    def __str__(self):
        base = super().__str__()
        if not self.history:
            return base
        return base + "\nfailure history:\n" + "\n".join(
            "  " + line for line in self.history)


def run_with_timeout(fn, timeout_s: Optional[float]):
    """Run ``fn()``; raise :class:`ChunkTimeout` after ``timeout_s``.

    Thread-based: the work runs on a daemon worker joined with a timeout.
    A running computation cannot be killed, so a timed-out worker is
    *abandoned*: it finishes (or hangs) in the background -- on a card it
    keeps launching on the same stream -- while the watchdog rolls back.
    The server fences its late result off by generation.
    ``timeout_s=None`` calls ``fn`` inline (no thread).
    """
    if timeout_s is None:
        return fn()
    box = {}

    def _worker():
        try:
            box["value"] = fn()
        except BaseException as e:          # handed to the caller thread
            box["error"] = e

    th = threading.Thread(target=_worker, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        raise ChunkTimeout(f"chunk exceeded {timeout_s:g}s wall-clock")
    if "error" in box:
        raise box["error"]
    return box["value"]
