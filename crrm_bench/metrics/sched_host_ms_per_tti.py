"""sched_host_ms_per_tti: the host time of the program's ``crrm.sched``
spans (the allocation and the served bits) over the window's TTIs, in
milliseconds (``harness/spans.py``)."""
from crrm_bench.harness import spans


def read(tr, ctx):
    return spans.host_ms_per_tti(tr, ctx, spans.SCHED)
