"""Inner loop (solver/inner.py): ms per traced solve spent making the
inner chunk's CUDA graph, the wall time of the port's
``sdplr.inner.capture`` spans (warm-up steps, the capture and the
graph's memory pool) over its ``sdplr.solve`` spans."""

from portbench import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.per_solve_ms("sdplr.inner.capture", "wall_s")
