"""device_idle_pct: the share of the traced window in which no operation
runs on the device -- one minus the union of the device intervals of the
trace, over the window's host-clock length -- in percent."""
from crrm_bench.harness import trace as _trace


def read(tr, ctx):
    if not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - _trace.busy_s(tr) / tr.window_s)
