"""ms_per_tti: every TTI simulated in the measured window over the
window's host-clock length, in milliseconds; not a median of calls."""


def read(tr, ctx):
    return ctx["window_s"] / ctx["ttis"] * 1e3
