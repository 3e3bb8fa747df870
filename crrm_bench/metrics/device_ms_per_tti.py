"""device_ms_per_tti: the summed device time of the kernels in the traced
window over the TTIs the window simulated, in milliseconds."""


def read(tr, ctx):
    ks = tr.kernels()
    if not ks or not ctx["ttis"]:
        return None
    return sum(e - s for _, s, e in ks) / 1e3 / ctx["ttis"]
