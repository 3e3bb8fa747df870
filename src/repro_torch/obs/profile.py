"""Profiling hooks: traces, annotations and stage timers.

The port of ``repro.obs.profile``:

* :func:`trace` -- context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where the host has a card): writes a
  Chrome trace of everything launched inside it into ``log_dir`` and
  yields the profiler, whose ``key_averages()`` the caller may read
  (:func:`kernel_times` sums them by device kernel);
* :func:`annotate` -- a named ``torch.profiler.record_function`` scope, so
  engine phases (prepare / rollout / sync) are legible in that trace;
* :class:`StageTimer` -- the per-stage wall-time breakdown: synchronises
  the device of each stage's output tensors and renders an aligned table
  of stage -> (calls, total ms, share).

Unlike the reference, :func:`trace` does not degrade to a no-op: the port
has no silent fallback, so a profiler that fails raises.

The reference's ``CompileCounter``, ``RetraceWatch`` and
``executable_cache_size`` count XLA compilations and jit-cache
specialisations.  Eager PyTorch compiles no program and keeps no such
cache, so they have no analogue here and are not defined.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch

from repro_torch import tree

#: the file :func:`trace` writes into its ``log_dir``
TRACE_FILE = "trace.json"


def _synchronize_cards():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its Chrome trace to
    ``log_dir/``:data:`TRACE_FILE`.

    The card is synchronised on entry and before the profiler stops, so
    the trace holds the block's device work and nothing queued before it.
    Yields the ``torch.profiler.profile`` object.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _synchronize_cards()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _synchronize_cards()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named ``record_function`` scope: ``with annotate("rollout"):
    fns.rollout(...)`` shows as a labelled span in a :func:`trace`."""
    return torch.profiler.record_function(name)


def kernel_times(prof) -> Dict[str, tuple]:
    """``{kernel: (device us, launches)}`` of a finished :func:`trace`:
    every event with device time of the CUDA device type."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (us, e.count)
    return out


def synchronize(out) -> None:
    """Wait for the devices of every tensor in ``out`` (a nested container
    of tensors, as ``repro_torch.tree`` walks them)."""
    for dev in {x.device for x in tree.flatten(out)[1]
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating per-stage wall-clock breakdown (host-side, blocking).

    ``time(stage, fn, *args)`` runs ``fn`` and synchronises the devices of
    its output tensors (so asynchronous launches cannot leak one stage's
    device time into the next); ``stage(name)`` is the context-manager
    spelling for arbitrary blocks.  ``report()`` renders stage -> (calls,
    total ms, share) aligned rows.
    """

    def __init__(self):
        self._total: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._total[name] = self._total.get(name, 0.0) + dt
            self._calls[name] = self._calls.get(name, 0) + 1

    def time(self, name: str, fn: Callable, *args, **kw):
        """Run ``fn`` under ``stage(name)``, synchronising on its output."""
        with self.stage(name):
            out = fn(*args, **kw)
            synchronize(out)
        return out

    def total_s(self, name: str) -> float:
        return self._total.get(name, 0.0)

    def calls(self, name: str) -> int:
        return self._calls.get(name, 0)

    def report(self, prefix: str = "") -> str:
        if not self._total:
            return f"{prefix}(no stages timed)"
        grand = sum(self._total.values())
        width = max(len(n) for n in self._total)
        rows = []
        for name, tot in sorted(self._total.items(), key=lambda kv: -kv[1]):
            share = tot / grand if grand else 0.0
            rows.append(f"{prefix}{name:<{width}}  x{self._calls[name]:<4d} "
                        f"{tot * 1e3:9.1f} ms  {share:6.1%}")
        return "\n".join(rows)
