"""Device (one H100): the share of the traced sub-window of whole solves
in which no operation ran on the card, from the profiler's trace (the
union of the device's kernel, copy and set intervals)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["kernels"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
