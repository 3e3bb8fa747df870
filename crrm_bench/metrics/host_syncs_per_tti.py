"""host_syncs_per_tti: the host's waits on the device
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) that start inside any of the program's ``crrm.*``
spans, over the window's TTIs (``harness/spans.py``).  The harness's own
synchronise after each call lies outside every span and is not counted."""
from crrm_bench.harness import spans


def read(tr, ctx):
    return spans.syncs_per_tti(tr, ctx)
