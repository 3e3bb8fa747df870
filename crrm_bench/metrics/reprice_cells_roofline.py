"""reprice_cells_roofline: the least time of the traced window's
``reprice_cells`` launches under the H100's published memory rate, over
their device time, in percent.  The work of one launch is one pass over
every UE row, counted from the cell's parameters: the carried (N, M) gain
read once (4 N M bytes), the attachment (4 N) and the SINR (4 N K) written
once; no operation term (the pass is bound by its bytes).  No launch in the
trace, or a faded configuration (whose gains carry a frequency axis and an
unfaded copy, not counted here): no reading."""
from crrm_bench.harness import yardstick


def read(tr, ctx):
    evs = [(s, e) for name, s, e in tr.device
           if "reprice_cells_kernel" in name]
    p = ctx["params"]
    if not evs or p.get("rayleigh_fading"):
        return None
    n, m = int(p["n_ues"]), int(p["n_cells"])
    k = int(p.get("n_subbands", 1)) * int(p.get("n_rb_subbands", 1))
    nbytes = 4 * n * m + 4 * n + 4 * n * k
    device_s = sum(e - s for s, e in evs) / 1e6
    return 100.0 * len(evs) * yardstick.bound_s(0, nbytes) / device_s
