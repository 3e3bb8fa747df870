"""sched_device_ms_per_tti: the device time of the kernels launched inside
the program's ``crrm.sched`` spans (pf weights, the segment reductions,
the served bits) over the window's TTIs, in milliseconds
(``harness/spans.py``)."""
from crrm_bench.harness import spans


def read(tr, ctx):
    return spans.device_ms_per_tti(tr, ctx, spans.SCHED)
