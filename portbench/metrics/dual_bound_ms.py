"""Dual bound (ops/lanczos.py, ops/blocklanczos.py, solver/dualbound.py):
the measured dual time, ms per traced solve: the wall time of the port's
``sdplr.dual_bound`` spans (one Lanczos bound, scalar or block, through
its host read) over its ``sdplr.solve`` spans."""

from portbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.per_solve_ms("sdplr.dual_bound", "wall_s")
