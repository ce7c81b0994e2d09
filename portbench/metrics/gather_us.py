"""Operators (ops/spmm.py, ops/gather.py, csrc/gather.cu): device µs per
launch of the gather_rows kernel over the traced solves, from the
profiler's trace."""

KERNEL = "gather_rows_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    hits = [v for k, v in ctx.trace["kernels"].items() if KERNEL in k]
    n = sum(c for _, c in hits)
    return 1e6 * sum(s for s, _ in hits) / n if n else None
