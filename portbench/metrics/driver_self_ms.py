"""Outer driver and major state machine (solver/outer.py): ms per traced
solve that no span below ``sdplr.solve`` names, the self time of the
port's ``sdplr.solve`` spans: the host loop's own Python between the
preprocessing, set-up, state reads, inner activations, boundaries, rank
doublings and the finish."""

from portbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.per_solve_ms("sdplr.solve", "self_s")
