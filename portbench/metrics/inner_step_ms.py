"""Inner loop (solver/inner.py, its captured chunk): device ms per inner
step of the cell's first instance at the starting rank, by the harness's
probe after the window (CUDA events, slope between two run lengths)."""


def read(ctx):
    p = ctx.probe("inner_step")
    return None if p is None else p["ms_per_step"]
