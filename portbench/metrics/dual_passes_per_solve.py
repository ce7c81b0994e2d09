"""Dual bound (ops/lanczos.py, ops/blocklanczos.py, solver/dualbound.py):
the mean of the solves' ``dual_passes``, the operator passes their
Lanczos bounds took."""


def read(ctx):
    p = [s["dual_passes"] for s in ctx.records if "dual_passes" in s]
    return sum(p) / len(p) if p else None
