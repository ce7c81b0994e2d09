"""Everything the benchmark takes from the system under test, the
PyTorch/CUDA port ``sdplrplus_tpu_torch``: its public entry ``sdplr``,
the counters it keeps (inner-loop STATS, ELL SpMMs, gather, K1 and K2
launches) and, for the inner-step probe, its inner loop. No other module
of the harness imports the port.

The port builds its CUDA kernels with nvcc at first use into
``SDPLRPLUS_TORCH_BUILD``; ``use_build_dir`` points that at one fixed
directory inside the checkout before the port is imported, so only the
first run in a checkout compiles.
"""

from __future__ import annotations

import collections
import os

import numpy as np

BUILD_ENV = "SDPLRPLUS_TORCH_BUILD"


def use_build_dir(path: str) -> None:
    os.environ[BUILD_ENV] = os.path.abspath(path)


def constraints(n: int) -> list:
    """The MaxCut constraints Xᵢᵢ = 1 in the port's own operand type,
    made once and shared by every instance of side n."""
    from sdplrplus_tpu_torch import sparse_coo

    return [sparse_coo([i], [i], [1.0], n) for i in range(n)]


def operands(pool: list) -> list:
    """Each instance's constraints in the port's operand types, in pool
    order, made once in set-up: its own (``Entries`` as ``sparse_coo``,
    ``LowRank`` as ``SymLowRank``), or, where it has none, the diagonal
    constraints of its side, one list per n shared by all such
    instances."""
    from sdplrplus_tpu_torch import SymLowRank, sparse_coo

    from .instance import LowRank

    shared, out = {}, []
    for inst in pool:
        if inst.constraints is None:
            if inst.n not in shared:
                shared[inst.n] = constraints(inst.n)
            out.append(shared[inst.n])
        else:
            out.append([SymLowRank(a.B, a.d) if isinstance(a, LowRank)
                        else sparse_coo(a.rows, a.cols, a.vals, inst.n)
                        for a in inst.constraints])
    return out


def solve(inst, As, solver: dict, *, seed: int, maxtime: float,
          device: str) -> dict:
    """One solve of ``inst`` (its constraints ``As`` in the port's types)
    through the port's public entry point; the constraint types are passed
    only where the instance has them."""
    from sdplrplus_tpu_torch import sdplr

    kw = {} if inst.types is None else {"constraint_types": inst.types}
    return sdplr(inst.C, As, inst.b, int(solver["r0"]),
                 ptol=float(solver["ptol"]),
                 objtol=float(solver["objtol"]),
                 prior_trace_bound=float(inst.trace_bound),
                 numlbfgsvecs=int(solver["lbfgs_pairs"]),
                 dtype=solver["dtype"], printlevel=0, seed=int(seed),
                 maxtime=float(maxtime), device=device, **kw)


def counters() -> collections.Counter:
    """The port's own counts so far; a window reads the difference."""
    from sdplrplus_tpu_torch.ops import gather, megakernel, spmm
    from sdplrplus_tpu_torch.solver import inner

    c = collections.Counter({f"inner.{k}": v for k, v in inner.STATS.items()})
    c["spmm.ell"] = spmm.CALLS["spmm_ell"]
    c["gather_rows.launches"] = gather.ROWS.launches
    c["k1.launches"] = megakernel.K1.launches
    c["k2.launches"] = megakernel.K2.launches
    return c


def n_pad(inst, As) -> int:
    """Rows of the port's padded layout of this problem."""
    from sdplrplus_tpu_torch import SDPProblem, compile_problem

    return int(compile_problem(
        SDPProblem(inst.C, list(As), inst.b, inst.types)).n_pad)


def inner_step_probe(inst, As, *, r: int, k: int, dtype: str, device: str,
                     steps=(100, 2000)) -> dict:
    """Device milliseconds per inner L-BFGS step of the port's torch inner
    loop on this instance at rank r, through its captured CUDA-graph chunk:
    runs of ``steps[0]`` and ``steps[1]`` steps from a seeded R, with the
    gradient tolerance −1 and the stagnation test off so that every run
    takes all its steps, timed with CUDA events in turns (small, big, big,
    small); the slope between the fastest of each size cancels the launch
    and capture costs."""
    import torch

    from sdplrplus_tpu_torch import SDPProblem, compile_problem
    from sdplrplus_tpu_torch.config import SolverConfig, resolve_dtype
    from sdplrplus_tpu_torch.ops.device import to_device
    from sdplrplus_tpu_torch.solver.al import al_value_grad
    from sdplrplus_tpu_torch.solver.inner import InnerGraphs, inner_chunk
    from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init

    dev = torch.device(device)
    cp = compile_problem(SDPProblem(inst.C, list(As), inst.b, inst.types))
    dp = to_device(cp, resolve_dtype(SolverConfig(dtype=dtype)), dev)
    lam = torch.zeros(dp.m, dtype=dp.dtype, device=dev)
    sigma = torch.tensor(2.0, dtype=dp.dtype, device=dev)
    graphs = InnerGraphs()

    def run(seed: int, nsteps: int) -> float:
        rng = np.random.default_rng(seed)
        R0 = np.zeros((dp.n_pad, r))
        R0[: dp.n] = rng.uniform(-1, 1, size=(dp.n, r))
        R = torch.tensor(R0, dtype=dp.dtype, device=dev)
        lb = lbfgs_init(k, dp.n_pad, r, dp.dtype, dev)
        L, vio, G, y, gn, _ = al_value_grad(dp, R, lam, sigma, True, True)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        carry, _ = inner_chunk(dp, R, G, y, vio, L, gn, lb, lam, sigma,
                               -1.0, float("-inf"), nsteps, k=k,
                               use_armijo=dp.has_inequalities,
                               gtol_relative=True,
                               ptol_relative=True, graphs=graphs)
        e1.record()
        torch.cuda.synchronize()
        if carry.steps != nsteps:
            raise RuntimeError(f"inner loop ran {carry.steps} of {nsteps} "
                               "steps")
        return e0.elapsed_time(e1)

    small, big = steps
    run(0, small)   # captures the chunk
    times = {small: [], big: []}
    for seed, nsteps in enumerate((small, big, big, small), start=1):
        times[nsteps].append(run(seed, nsteps))
    ms = (min(times[big]) - min(times[small])) / (big - small)
    return {"ms_per_step": ms, "n_pad": int(dp.n_pad), "r": r, "k": k,
            "dtype": dtype}
