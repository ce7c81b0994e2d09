"""Per-operator timer of the port: the card time of each hot operator.

Counterpart of the JAX package's ``exps/bench_micro.py`` (reference:
exps/bench.jl:1-122, which @btime's the 𝒜/𝒜ᵀ variants). On a seeded
MaxCut instance (``synthetic_graph(n, deg, seed=0)``, the JAX script's
draw) it times 𝒜(RRᵀ) (``A_uu``), the line search's pair
(``A_linesearch``), the gradient 2·S·R (``gradient``: the ELL SpMM with
its row gather through ``gather_rows`` when C is sparse, a matmul when
it is held dense), ``assemble_s_tri`` where the constraints are not all
diagonal, and the L-BFGS direction. Each is called N times back to back
after a warm-up, twice:

  * ``device_us``: the device time of the kernels the N calls launched,
    summed from ``torch.profiler``'s CUDA events, per call: the card's
    own time for the operator, with no host time in it;
  * ``issue_us``: CUDA events around the N eager calls, per call. An
    operator here is 10–40 small torch ops, so this is the rate at which
    the host issues them, not the card's time.

Each line gives both, the kernels per call, the least time the card could
take (``utils/timing.py``: every input byte read once and every output
byte written once at 3.35 TB/s, the operations at 67 TFLOP/s FP32 or 34
TFLOP/s FP64; the larger of the two), the share of it the device time
reaches, and GFLOP/s for the gradient, as the JAX script prints.

    python -m sdplrplus_tpu_torch.exps.bench_micro --synthetic-n 20000 \\
        --deg 16 --rank 10 [--iters 500] [--dtype float32]

Without a card it raises; with ``--device cpu`` it gives only the host
clock's time per call, labelled a CPU time, and no device time.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..config import require_device
from ..utils.timing import Timer, bound_s, kernel_us


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="per-operator timer (port)")
    p.add_argument("--synthetic-n", type=int, default=800)
    p.add_argument("--deg", type=int, default=24)
    p.add_argument("--rank", type=int, default=10)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _C_parts(dp):
    """The tensors a product with C reads: dense C, or the ELL ids and
    C's values at them (both tiers)."""
    if dp.C_dense is not None:
        return (dp.C_dense,)
    return (dp.ell_ids, dp.cell_val, dp.cell2_val, dp.ell2_rows)


def _c_slots(dp) -> int:
    """Multiply-adds per column of a product with C."""
    if dp.C_dense is not None:
        return dp.n_pad * dp.n_pad
    return dp.ell_ids.numel()


def main(argv=None) -> list:
    from ..compile import compile_problem
    from ..config import SolverConfig, resolve_dtype
    from ..models import maxcut, synthetic_graph
    from ..ops.adjoint import assemble_s_tri, gradient
    from ..ops.device import to_device
    from ..ops.forward import A_linesearch, A_uu
    from ..problem import SDPProblem
    from ..solver.lbfgs import lbfgs_direction, lbfgs_init
    from .common import device_info

    args = parse_args(argv)
    dev = require_device(args.device, "the micro-benchmark's device")
    dtype = resolve_dtype(SolverConfig(dtype=args.dtype))
    # the JAX script's graph: synthetic_graph's draw with seed 0
    A = synthetic_graph(args.synthetic_n, args.deg, seed=0)
    C, As, b = maxcut(A)
    cp = compile_problem(SDPProblem(C, list(As), b, None))
    dp = to_device(cp, dtype, dev)
    r, N, k = args.rank, args.iters, 4
    rng = np.random.default_rng(0)
    pad = ((0, cp.n_pad - cp.n), (0, 0))
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
    R = t(np.pad(rng.uniform(-1, 1, (cp.n, r)), pad))
    D = t(np.pad(rng.uniform(-1, 1, (cp.n, r)), pad))
    lam = torch.zeros(cp.m, dtype=dtype, device=dev)
    sigma = t(2.0)
    y_full = torch.cat([lam, torch.ones(1, dtype=dtype, device=dev)])
    vio = torch.zeros(cp.m + 1, dtype=dtype, device=dev)
    lb = lbfgs_init(k, cp.n_pad, r, dtype, dev)
    lb.s_hist.copy_(t(rng.uniform(-1, 1, lb.s_hist.shape)))
    lb.y_hist.copy_(t(rng.uniform(-1, 1, lb.y_hist.shape)))
    lb.rho.fill_(1.0)
    info = device_info(dev)
    form = "dense C" if dp.C_dense is not None else "ELL SpMM"
    it = torch.finfo(dtype).bits // 8
    nr, m1 = cp.n_pad * r, cp.m + 1
    cons = (dp.con_rows, dp.con_val_two)
    diag = (dp.diag_cid, dp.diag_w)
    csl = _c_slots(dp)

    # (name, fn, bytes read and written once, operations)
    ops = [
        ("A_uu", lambda: A_uu(dp, R),
         _nbytes(R, *_C_parts(dp), *cons) + m1 * it,
         2 * csl * r + 4 * nr),
        ("A_linesearch", lambda: A_linesearch(dp, R, D),
         _nbytes(R, D, *_C_parts(dp), *cons) + 2 * m1 * it,
         2 * csl * r + 10 * nr),
        (f"gradient ({form})", lambda: gradient(dp, R, lam, sigma, vio),
         _nbytes(R, lam, vio, *_C_parts(dp), *diag) + nr * it,
         2 * csl * r + 4 * nr),
    ]
    if not dp.all_cons_diagonal:
        ops.append(("assemble_s_tri", lambda: assemble_s_tri(dp, y_full),
                    _nbytes(y_full, dp.pos_cid, dp.pos_val, dp.c_val_one)
                    + dp.P_pad * it, 2 * dp.pos_val.numel() + dp.P_pad))
    ops.append(("lbfgs_direction", lambda: lbfgs_direction(lb, R, k),
                _nbytes(R, lb.s_hist, lb.y_hist, lb.rho, lb.sty, lb.yty)
                + nr * it, 8 * k * nr + nr))

    rows = []
    on_card = dev.type == "cuda"
    dname = str(dtype).removeprefix("torch.")
    for name, fn, nbytes, flops in ops:
        fn()  # warm-up: kernel builds, cuBLAS/cuSPARSE handles, allocator
        timer = Timer(dev)
        timer.start()
        for _ in range(N):
            fn()
        issue_us = timer.stop() * 1e6 / N
        device_us = kernels = None
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(N):
                    fn()
                torch.cuda.synchronize()
            ks = kernel_us(prof).values()
            device_us = sum(us for us, _ in ks) / N
            kernels = sum(c for _, c in ks) / N
            if not device_us > 0:
                raise RuntimeError(f"{name}: torch.profiler recorded no "
                                   f"device time on {dev}")
        bound, bound_by = bound_s(nbytes, flops, dname)
        bound_us = 1e6 * bound
        row = dict(op=name, device_us=device_us, issue_us=issue_us,
                   kernels_per_call=kernels, bound_us=bound_us,
                   bound_by=bound_by,
                   share_of_bound=bound_us / device_us if on_card else None,
                   bytes=nbytes, flops=flops,
                   gflops=(flops / device_us / 1e3
                           if on_card and name.startswith("gradient")
                           else None),
                   device_timer=("torch.profiler, the kernels' device time "
                                 "summed" if on_card else None),
                   issue_timer=(f"cuda events around {N} eager calls (the "
                                f"host's issue rate)" if on_card else
                                "host clock (CPU, not a device time)"),
                   n=cp.n, n_pad=cp.n_pad, r=r, dtype=dname, iters=N,
                   **info)
        rows.append(row)
        if on_card:
            gf = f" {row['gflops']:.1f} GFLOP/s" if row["gflops"] else ""
            head = (f"device {device_us:9.2f} us/call ({kernels:g} kernels),"
                    f" host-issue {issue_us:.2f} us/call, bound "
                    f"{bound_us:.2f} us ({bound_by}), "
                    f"{100 * row['share_of_bound']:.1f} % of it{gf}")
        else:
            head = (f"CPU {issue_us:9.2f} us/call (host clock), bound on "
                    f"the card {bound_us:.2f} us ({bound_by})")
        print(f"[micro] {name:28s} {head} | n={cp.n} r={r} {dname} on "
              f"{info['device']} | {json.dumps(row)}", flush=True)
    print(f"n={cp.n} n_pad={cp.n_pad} P={cp.P} W={cp.ell_width} "
          f"C slots {csl} ({form}) r={r} dtype={dtype}", flush=True)
    return rows


if __name__ == "__main__":
    main()
