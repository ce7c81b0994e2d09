"""Kernels of the fast-diagonal step: the least time of one inner
L-BFGS step with sparse C (counts/lbfgs_step.fastdiag_step at the
port's padded rows, C's stored entries, the starting rank and the
L-BFGS pairs; the larger of its bytes at peak bandwidth and its
operations at the FP32 peak) over the device time per step of the
inner-step probe, in %."""

from portbench.counts import lbfgs_step, peaks


def read(ctx):
    p = ctx.probe("inner_step")
    if p is None or p["ms_per_step"] <= 0:
        return None
    C = ctx.pool[0].C
    flops, nbytes = lbfgs_step.fastdiag_step(p["n_pad"], C.nnz, p["r"],
                                             p["k"])
    least, _ = peaks.least_s(flops, nbytes, p["dtype"])
    return 100.0 * least / (1e-3 * p["ms_per_step"])
