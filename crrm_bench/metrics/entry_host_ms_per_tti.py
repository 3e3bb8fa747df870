"""entry_host_ms_per_tti: the host time of the entries around the TTI loop
-- the program's ``crrm.rollout``, ``crrm.env.*`` and ``crrm.twin.*``
spans, less the ``crrm.tti`` and ``crrm.radio_init`` spans nested in them
-- over the window's TTIs, in milliseconds (``harness/spans.py``)."""
from crrm_bench.harness import spans


def read(tr, ctx):
    return spans.entry_ms_per_tti(tr, ctx)
