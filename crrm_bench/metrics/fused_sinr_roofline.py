"""fused_sinr_roofline: the least time of the traced window's
``fused_sinr`` launches under the H100's published peaks, over their
device time, in percent.  The work is the frozen count of
``harness/yardstick.py`` at each launch's shapes: the window's dirty rows
spread over its launches, against every cell, with the row index read as
int32 and no fading rows (the configurations it applies to are unfaded).
No launch in the trace: no reading."""
from crrm_bench.harness import yardstick


def read(tr, ctx):
    evs = [(s, e) for name, s, e in tr.device if "fused_sinr_kernel" in name]
    n = ctx["fused_sinr_launches"]
    if not evs or not n:
        return None
    p = ctx["params"]
    if p.get("rayleigh_fading"):
        return None               # fading rows are not counted here
    rows = ctx["fused_sinr_rows"] / n
    cells = int(p["n_cells"])
    k = int(p.get("n_subbands", 1)) * int(p.get("n_rb_subbands", 1))
    ops, nbytes = yardstick.fused_sinr_work(
        round(rows), cells, k, p["pathloss_model_name"],
        int(p.get("n_sectors", 1)), idx_bytes=4 * round(rows))
    device_s = sum(e - s for s, e in evs) / 1e6
    return 100.0 * n * yardstick.bound_s(ops, nbytes) / device_s
