"""Outer driver and major state machine (solver/major.py): ms per traced
solve of the major boundaries' own host time, the self time of the
port's ``sdplr.boundary`` spans (their wall time less the dual bounds
inside them), over its ``sdplr.solve`` spans."""

from portbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.per_solve_ms("sdplr.boundary", "self_s")
