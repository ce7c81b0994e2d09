"""Kernels: K1 (csrc/megakernel.cu), the dense inner-loop megakernel:
its least time over the traced solves over its device time there, in %.
The least time is the larger of the iterations' operations at the FP32
peak (counts/lbfgs_step.k1_iteration_flops at the port's padded rows,
the starting rank, the least any iteration runs at, and the L-BFGS
pairs) and the launches' bytes at
peak bandwidth (``k1_launch_bytes``, one read of dense C per launch).
The iterations are the solves' ``iter``, all run by K1 on this path; the
device time is the trace's time of the kernel named k1_kernel."""

from portbench.counts import lbfgs_step, peaks

KERNEL = "k1_kernel"


def read(ctx):
    if ctx.trace is None or ctx.counts is None:
        return None
    dev_s = sum(v[0] for k, v in ctx.trace["kernels"].items() if KERNEL in k)
    launches = ctx.counts["k1.launches"]
    solves = [s for s in ctx.traced if "iter" in s]
    if (dev_s <= 0 or not launches or not solves
            or any(s["engine"] != "cuda-megakernel" for s in solves)):
        return None
    n = ctx.probe("n_pad")
    r = int(ctx.config["solver"]["r0"])
    k = int(ctx.config["solver"]["lbfgs_pairs"])
    flops = sum(s["iter"] for s in solves) * lbfgs_step.k1_iteration_flops(
        n, r, k)
    nbytes = launches * lbfgs_step.k1_launch_bytes(n, r, k)
    least, _ = peaks.least_s(flops, nbytes)
    return 100.0 * least / dev_s
