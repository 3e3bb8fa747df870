"""The program's stage spans in a :class:`~crrm_bench.harness.trace.Trace`.

The program opens host-only spans named ``crrm.*`` around its calls, TTIs
and stages (``repro_torch.obs.profile.SPANS``): host operations on the
profiler's clock, like the CUDA runtime calls that launch kernels and wait
for the device.  A kernel is *launched inside* a span when its launch call
starts inside the span's interval.  The trace holds no correlation ids, so
the window's launch calls are paired with its kernels in start order, which
on the one stream the program uses is launch order; where the two counts
differ the pairing is unknown, and every reader here is silent.

Each reader returns ``None`` when the trace has no kernels (a CPU trace),
when the window holds none of the spans it reads (a program without them),
or when launches and kernels do not pair.
"""
from __future__ import annotations

import bisect

#: host events that launch one kernel each
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
#: host events that wait for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
PREFIX = "crrm."
RADIO = ("crrm.radio", "crrm.radio_init")
SCHED = ("crrm.sched",)
#: spans of the entries around the TTI loop, and those nested in them that
#: are not the entries' own time
ENTRY = ("crrm.rollout", "crrm.env.", "crrm.twin.")
NOT_ENTRY = ("crrm.tti", "crrm.radio_init")

def union(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint
    ``[start, end]`` pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def length(merged) -> float:
    return sum(e - s for s, e in merged)


def minus(merged, cut) -> list:
    """``merged`` with the intervals of ``cut`` (both as :func:`union`
    gives them) taken out."""
    out, j = [], 0
    for s, e in merged:
        while j < len(cut) and cut[j][1] <= s:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < e:
            if cut[k][0] > s:
                out.append([s, cut[k][0]])
            s = max(s, cut[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def within(merged):
    """``t -> bool``: whether ``t`` lies in one of the disjoint sorted
    intervals ``merged``."""
    starts = [s for s, _ in merged]

    def test(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= merged[i][1]
    return test


def named(tr, names) -> list:
    """Union of the host spans whose name is one of ``names`` or, for a
    name ending in ``.``, starts with it."""
    prefixes = tuple(x for x in names if x.endswith("."))
    return union((s, e) for n, s, e in tr.host
                 if n in names or n.startswith(prefixes))


def launched(tr):
    """``[(launch start, kernel device us)]`` of the window in launch order,
    or ``None`` when launch calls and kernels differ in number.  Kernels
    that read the same start keep the profiler's order, which is the
    stream's."""
    calls = sorted(s for n, s, _ in tr.host if n in LAUNCHES)
    kernels = sorted(((s, e) for _, s, e in tr.kernels()),
                     key=lambda k: k[0])
    if len(calls) != len(kernels):
        return None
    return [(c, e - s) for c, (s, e) in zip(calls, kernels)]


def _pairs(tr, ctx, merged):
    """The :func:`launched` pairs when a reader may read (kernels, TTIs,
    its spans, a pairing), else ``None``."""
    if not (tr.kernels() and ctx["ttis"] and merged):
        return None
    return launched(tr)


def host_ms_per_tti(tr, ctx, names):
    """Host time covered by the spans ``names`` over the window's TTIs."""
    merged = named(tr, names)
    if _pairs(tr, ctx, merged) is None:
        return None
    return length(merged) / 1e3 / ctx["ttis"]


def device_ms_per_tti(tr, ctx, names):
    """Device time of the kernels launched inside the spans ``names`` over
    the window's TTIs."""
    merged = named(tr, names)
    pairs = _pairs(tr, ctx, merged)
    if pairs is None:
        return None
    test = within(merged)
    return sum(d for t, d in pairs if test(t)) / 1e3 / ctx["ttis"]


def entry_ms_per_tti(tr, ctx):
    """Host time of the entry spans, less the TTIs and the radio set-up
    nested in them, over the window's TTIs."""
    merged = named(tr, ENTRY)
    if _pairs(tr, ctx, merged) is None:
        return None
    own = minus(merged, named(tr, NOT_ENTRY))
    return length(own) / 1e3 / ctx["ttis"]


def syncs_per_tti(tr, ctx):
    """Host waits on the device that start inside any program span, over
    the window's TTIs."""
    merged = named(tr, (PREFIX,))
    if _pairs(tr, ctx, merged) is None:
        return None
    test = within(merged)
    n = sum(1 for name, s, _ in tr.host if name in SYNCS and test(s))
    return n / ctx["ttis"]
