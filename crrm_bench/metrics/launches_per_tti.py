"""launches_per_tti: the kernel launches in the traced window (device
kernel events, copies and fills not counted) over its TTIs."""


def read(tr, ctx):
    ks = tr.kernels()
    if not ks or not ctx["ttis"]:
        return None
    return len(ks) / ctx["ttis"]
