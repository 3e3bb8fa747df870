"""The benchmark's own reader of a ``torch.profiler`` trace.

:func:`profile` runs a block under the profiler (host and CUDA activity),
synchronised at both ends, and returns a :class:`Trace`: the device
operations as ``(name, start_us, end_us)`` intervals, the host operations
likewise, and the wall length of the traced window on the host clock.
The per-layer metric readers of ``metrics/`` take their numbers from it.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

#: device operations that are not kernel launches
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


class Trace(NamedTuple):
    device: list        # [(name, start_us, end_us)] device operations
    host: list          # [(name, start_us, end_us)] host operations
    window_s: float     # host wall length of the traced block

    def kernels(self):
        return [e for e in self.device if not e[0].startswith(_NOT_KERNELS)]


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_s(tr: Trace) -> float:
    return union_us([(s, e) for _, s, e in tr.device]) / 1e6


def _from_events(prof):
    """Device and host events; a user annotation on the device (NCCL's
    ``nccl:all_reduce`` around its kernel) is no device operation."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False):
                continue
            dev.append((e.name, s, t))
        else:
            host.append((e.name, s, t))
    return dev, host


def profile(fn) -> Trace:
    """Run ``fn()`` under the profiler; its :class:`Trace`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    dev, host = _from_events(prof)
    return Trace(device=dev, host=host, window_s=window)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of
    the device summed by the innermost host operation running at the
    middle of each gap."""
    by_op = {}
    for name, s, e in tr.device:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    merged = []
    for s, e in sorted((s, e) for _, s, e in tr.device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    host = sorted(tr.host, key=lambda h: h[1])
    gaps, active, j = {}, [], 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        while j < len(host) and host[j][1] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[2] >= mid]
        label = (min(active, key=lambda h: h[2] - h[1])[0] if active
                 else "(no host operation)")
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}
