"""Profiling hooks: traces, annotations and stage timers.

The port of ``repro.obs.profile``:

* :func:`trace` -- context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where the host has a card): writes a
  Chrome trace of everything launched inside it into ``log_dir`` and
  yields the profiler, whose ``key_averages()`` the caller may read
  (:func:`kernel_times` sums them by device kernel);
* :func:`annotate` -- a named host-only span, so engine phases are legible
  in that trace; the port's own spans are the fixed names of
  :data:`SPANS`, each on the code it names;
* :class:`StageTimer` -- the per-stage wall-time breakdown: synchronises
  the device of each stage's output tensors and renders an aligned table
  of stage -> (calls, total ms, share).

Unlike the reference, :func:`trace` does not degrade to a no-op: the port
has no silent fallback, so a profiler that fails raises.

Spans are host-only ranges.  A ``torch.profiler.record_function`` range is
a user annotation, and with CUDA activity on, the profiler copies it onto
the device timeline as an event of the CUDA device type: a reader that
takes every CUDA event for a kernel (launch counts, device time, idle
gaps) would count each span as a kernel as long as its range.
``_RecordFunctionFast`` records a plain host operation instead, on the
profiler's clock, so a span names the kernels launched inside it without
being one.  With no profiler recording, :func:`annotate` returns one shared
no-op context manager: a span costs one flag read, where an idle
``record_function`` allocates and costs ~11 us (the H100 machine's host).

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
from torch.autograd import profiler as _autograd_profiler

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


#: the port's spans: name -> the code it covers.  A span's parent is the
#: span enclosing it on its thread: a TTI's stages sit inside its
#: ``crrm.tti``, and that inside the call's ``crrm.rollout``.
SPANS = {
    "crrm.rollout": "mac/engine.py, one step or rollout call: its TTIs, "
                    "the set-up and the stacking of the outputs",
    "crrm.radio_init": "mac/engine.py setup(): the hoisted dense constants "
                       "and the RadioState of a call (one per env in a "
                       "batch)",
    "crrm.tti": "mac/engine.py, one TTI: tti_step, or batch_tti for a "
                "batch of envs",
    "crrm.churn": "mac/engine.py channel(): births and deaths, the MAC "
                  "leaves they reset, the newborn rows scattered",
    "crrm.faults": "mac/engine.py channel(): the fault transition and the "
                   "tx mask",
    "crrm.radio": "mac/engine.py channel(): the dirty rows (walk, window "
                  "index, fused_sinr or the torch rows), the fault "
                  "re-pricing, or the dense chain (gains, RSRP, "
                  "attachment, SINR to SE)",
    "crrm.handover": "mac/engine.py channel(): newborn attachment, the A3 "
                     "step and the serving-cell gather",
    "crrm.traffic": "mac/engine.py mac(): the arrivals",
    "crrm.sched": "mac/engine.py mac(): the allocation (pf weights, the "
                  "segment reductions of mac/segments.py) and the served "
                  "bits",
    "crrm.harq": "mac/engine.py mac(): HARQ or HARQ-lite, the drain, the "
                 "pf average update",
    "crrm.telemetry": "mac/engine.py step_telemetry(): the TTI's KPIs",
    "crrm.env.step": "env/crrm_env.py: one step, step_autoreset, "
                     "step_batch or step_autoreset_batch call (the "
                     "outermost)",
    "crrm.env.reset": "env/crrm_env.py: an autoreset's fresh episode and "
                      "its torch.where",
    "crrm.env.score": "env/crrm_env.py _scored(): observation, reward, "
                      "done, reward components",
    "crrm.twin.chunk": "twin/server.py step_chunk(): one chunk, guarded or "
                       "not",
    "crrm.twin.summary": "twin/server.py: the chunk's KPI summary and its "
                         "t and active_ues reads",
    "crrm.twin.guard": "twin/server.py: carry_ok / carry_violations after "
                       "a guarded chunk",
    "crrm.twin.checkpoint": "twin/server.py checkpoint()",
    "crrm.twin.restore": "twin/server.py restore()",
}

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named host-only span: ``with annotate("crrm.tti"): ...`` shows as
    a host operation of that name in a :func:`trace` (module docstring).
    With no profiler recording it returns one shared no-op context
    manager."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


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
