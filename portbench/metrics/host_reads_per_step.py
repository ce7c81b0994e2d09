"""Outer driver and major state machine (solver/outer.py,
solver/major.py): the host's reads of device state per inner step over
the traced solves, from the port's inner-loop counters (one read per
chunk replay, one per branch of the state machine)."""


def read(ctx):
    if ctx.counts is None:
        return None
    steps = ctx.counts["inner.steps"]
    if not steps:
        return None
    return (ctx.counts["inner.reads"] + ctx.counts["inner.branch_reads"]) \
        / steps
