"""step_p95_ms: the 95th percentile of the latency of every call in the
window, each from the call until its outputs are synchronised, in
milliseconds."""
import numpy as np


def read(tr, ctx):
    return float(np.percentile(ctx["call_ms"], 95))
