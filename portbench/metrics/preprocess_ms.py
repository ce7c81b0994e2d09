"""Problem build (problem.py, compile.py, ops/device.py): the mean of
the solves' own ``preprocess_time`` (host clock around compile_problem
and to_device), in ms."""


def read(ctx):
    t = [s["preprocess_s"] for s in ctx.records if "preprocess_s" in s]
    return 1e3 * sum(t) / len(t) if t else None
