"""Benchmark of the port: MaxCut SDP under the reference's headline
protocol (relative ptol = objtol = 1e-2, initial rank 10, trace bound n;
reference: exps/test.jl:176-210). Counterpart of the JAX package's
``bench.py``.

    python -m sdplrplus_tpu_torch.bench [--device cpu]

Measurements, on the card unless ``--device cpu``:
  * G1-shaped (``make_random_graph(800, 0.83, seed=1)``; the Gset files
    are not in the repository): the inner loop's device iteration rate,
    as the slope between a 100- and a 100,000-step launch of K1 with gtol
    −1 and the stagnation test off, timed with CUDA events in turns
    (small, big, big, small), which cancels the launch latency (the
    torch inner loop where K1 is ineligible; ``inner_engine`` says
    which); and the warm end-to-end time to 1e-2 (a warm-up solve first);
  * SYN20K (``synthetic_graph(20000, 16)``, the instance RND20000d16 of
    the measured CPU baseline): the warm end-to-end time to 1e-2.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"detail"}. The headline is the SYN20K time to 1e-2, and ``vs_baseline``
is the CPU baseline's ``totaltime`` on the same instance, read from
``exps/output/baseline_cpu/MaxCut/RND20000d16.json`` (a single-thread
numpy/scipy port of the reference hot loop, ``exps/ref_baseline.py``),
over it. The G1-shaped graph gets no ``vs_baseline``: the committed G1
baseline is the real Gset G1, another graph. A failed live run fails the
benchmark; nothing is read from a committed artifact in its place.
Every block of the detail names the device it ran on and, on the card,
its power limit. Without a card it raises unless ``--device cpu`` is
given, and then the times are host times of the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .config import require_device
from .exps.common import OUTPUT, REPO, device_info, setup_cache
from .utils.timing import Timer

BASELINE_20K = os.path.join(OUTPUT, "baseline_cpu", "MaxCut",
                            "RND20000d16.json")
K = 4          # L-BFGS pairs (SolverConfig.numlbfgsvecs)
RANK = 10


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def inner_loop_rate(dp, r: int = RANK, *, steps=(100, 100_000),
                    repeats: int = 2):
    """(iterations per second, engine) of the inner L-BFGS loop on
    ``dp``'s device: K1 (its plain version on the CPU) when eligible, else
    the torch inner loop, whose big run is capped at 4000 steps. The rate
    is the slope between ``steps[0]`` and ``steps[1]`` iterations, each
    run from a fresh seeded R with gtol −1 and the stagnation test off,
    taken over ``repeats`` turns (small, big, big, small), the fastest of
    each size."""
    from .ops import megakernel as mk
    from .solver.al import al_value_grad
    from .solver.inner import inner_chunk
    from .solver.lbfgs import lbfgs_init
    from .solver.outer import _engine_name

    dtype, dev = dp.dtype, dp.device
    use_mega = mk.megakernel_eligible(dp, r, K, False, dtype)
    small, big = steps if use_mega else (steps[0], min(steps[1], 4000))
    if use_mega:
        meta, data = mk.prepare_mega_data(dp, k=K, gtol_relative=True,
                                          ptol_relative=True)
        spec = mk.mega_spec_for(meta, r)
        run_k1 = mk.mega_kernel if dev.type == "cuda" \
            else mk.mega_chunk_plain
    lam = torch.zeros(dp.m, dtype=dtype, device=dev)
    sigma = torch.tensor(2.0, dtype=dtype, device=dev)
    timer = Timer(dev)

    def run(seed: int, nsteps: int) -> float:
        rng = np.random.default_rng(seed)
        R0 = np.zeros((dp.n_pad, r))
        R0[: dp.n] = rng.uniform(-1, 1, size=(dp.n, r))
        R = torch.tensor(R0, dtype=dtype, device=dev)
        lb = lbfgs_init(K, dp.n_pad, r, dtype, dev)
        if use_mega:
            args = mk.mega_inputs(spec, r, data, R, lb, lam, sigma, -1.0,
                                  float("-inf"), nsteps)
            timer.start()
            out = run_k1(spec, *args)
            dt = timer.stop()
            done = int(out[3][3])
        else:
            L, vio, G, y, gn, _ = al_value_grad(dp, R, lam, sigma, True,
                                                True)
            timer.start()
            carry, _ = inner_chunk(dp, R, G, y, vio, L, gn, lb, lam, sigma,
                                   -1.0, float("-inf"), nsteps, k=K,
                                   use_armijo=False, gtol_relative=True,
                                   ptol_relative=True)
            dt = timer.stop()
            done = carry.steps
        _require(done == nsteps, f"inner loop ran {done} of {nsteps} steps")
        return dt

    run(0, small)  # build, load and warm
    times = {small: [], big: []}
    seed = 1
    for _ in range(repeats):
        for nsteps in (small, big, big, small):
            times[nsteps].append(run(seed, nsteps))
            seed += 1
    t_small, t_big = min(times[small]), min(times[big])
    _require(t_big > t_small, f"{big} steps took {t_big} s, no more than "
             f"{small} steps ({t_small} s)")
    return (big - small) / (t_big - t_small), _engine_name(dp, use_mega)


def _timed_solve(C, As, b, n: int, label: str, device, dtype: str,
                 maxtime: float):
    """Warm-up solve at the real tolerances, then the timed one: (result,
    wall seconds). A result is on the host when ``sdplr`` returns, so the
    host clock covers the whole solve."""
    from . import sdplr

    common = dict(prior_trace_bound=float(n), dtype=dtype, printlevel=0,
                  dataset=label, ptol=1e-2, objtol=1e-2, maxtime=maxtime,
                  device=device)
    sdplr(C, As, b, RANK, **common)
    t0 = time.time()
    res = sdplr(C, As, b, RANK, **common)
    return res, time.time() - t0


def _check_times(res: dict) -> None:
    """Timing sanity: fail rather than print an absurd JSON line (the JAX
    package's BENCH_r02 reported dual_time > totaltime). The fused driver's
    dual time is modelled (measured passes × a modelled unit cost) and its
    primal time is the rest of the total, so for it the sum checks only
    the bookkeeping; the host driver measures both."""
    total, dual, primal = res["totaltime"], res["dual_time"], res["primaltime"]
    _require(0.0 <= dual <= total, f"dual_time {dual} outside [0, {total}]")
    _require(primal >= 0.0, f"negative primaltime {primal}")
    _require(abs(primal + dual + res.get("preprocess_time", 0.0) - total)
             <= 0.05 * total + 1e-6,
             f"primal {primal} + dual {dual} != total {total}")
    _require(res["iter"] > 0 and total > 0, "empty solve")


def _split_times(res: dict) -> dict:
    """The solve's primal and dual seconds, under names that say whether
    they were measured or modelled."""
    kind = "modelled" if res["dual_time_estimated"] else "measured"
    return {f"primal_time_{kind}_s": res["primaltime"],
            f"dual_time_{kind}_s": res["dual_time"]}


def run_bench(A=None, *, label: str = "G1-shaped", device="cuda",
              dtype: str = "float32", steps=(100, 100_000),
              repeats: int = 2, maxtime: float = 600.0) -> dict:
    """The G1-shaped measurement (``A`` defaults to
    ``make_random_graph(800, 0.83, seed=1)``): the device iteration rate
    and the warm time to 1e-2."""
    from .compile import compile_problem
    from .config import resolve_dtype, SolverConfig
    from .models import make_random_graph, maxcut
    from .ops.device import to_device
    from .problem import SDPProblem

    dev = require_device(device, "the benchmark's device")
    if A is None:
        A = make_random_graph(800, 0.83, seed=1)
    n = A.shape[0]
    C, As, b = maxcut(A)
    cp = compile_problem(SDPProblem(C, list(As), b, None))
    dp = to_device(cp, resolve_dtype(SolverConfig(dtype=dtype)), dev)
    rate, engine = inner_loop_rate(dp, steps=steps, repeats=repeats)
    res, wall = _timed_solve(C, As, b, n, label, device, dtype, maxtime)
    _check_times(res)
    return {
        "graph": label,
        "n": n,
        "edges": int(A.nnz // 2),
        "obj": res["obj"],
        "primal_vio": res["primal_vio"],
        "rel_duality_gap": res["rel_duality_gap"],
        "iter": res["iter"],
        "majoriter": res["majoriter"],
        "device_al_iters_per_sec": rate,
        "rate_steps": list(steps),
        "inner_engine": engine,
        "solve_inner_engine": res["inner_engine"],
        "e2e_al_iters_per_sec": res["iter"] / res["totaltime"],
        "time_to_tol_s": wall,
        **_split_times(res),
        "timed_out": res["timed_out"],
        "dtype": res["dtype"],
        **device_info(dev),
    }


def run_bench_20k(*, n: int = 20000, deg: int = 16, device="cuda",
                  dtype: str = "float32", maxtime: float = 900.0) -> dict:
    """Warm time to 1e-2 on ``synthetic_graph(n, deg)``: SYN20K
    (RND20000d16) at the defaults."""
    from .models import maxcut, synthetic_graph

    dev = require_device(device, "the benchmark's device")
    A = synthetic_graph(n, deg)
    C, As, b = maxcut(A)
    res, wall = _timed_solve(C, As, b, n, f"RND{n}d{deg}", device, dtype,
                             maxtime)
    _check_times(res)
    return {
        "graph": f"RND{n}d{deg}",
        "n": n,
        "edges": int(A.nnz // 2),
        "obj": res["obj"],
        "primal_vio": res["primal_vio"],
        "rel_duality_gap": res["rel_duality_gap"],
        "iter": res["iter"],
        "majoriter": res["majoriter"],
        "r": res["r"],
        "time_to_tol_s": wall,
        "timed_out": res["timed_out"],
        "inner_engine": res["inner_engine"],
        "dtype": res["dtype"],
        **device_info(dev),
    }


def cpu_baseline(path: str = BASELINE_20K) -> dict:
    """The measured CPU baseline on RND20000d16 (exps/ref_baseline.py: one
    thread, ptol = objtol = 1e-2, r = 10, trace bound n)."""
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="SDPLRPlus port benchmark")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="float32")
    args = p.parse_args(argv)
    dev = require_device(args.device, "the benchmark's device")
    setup_cache()
    g1 = run_bench(device=dev, dtype=args.dtype)
    d20k = run_bench_20k(device=dev, dtype=args.dtype)
    base = cpu_baseline()
    vs = base["totaltime"] / d20k["time_to_tol_s"]
    d20k["baseline_cpu"] = {
        "solver": base.get("solver"),
        "time_to_tol_s": base["totaltime"],
        "obj": base["obj"],
        "rel_duality_gap": base["rel_duality_gap"],
        "source": os.path.relpath(BASELINE_20K, REPO),
    }
    line = {
        "metric": "time_to_tol_maxcut_n20000",
        "value": d20k["time_to_tol_s"],
        "unit": "s",
        "vs_baseline": vs,
        "detail": {
            "device": device_info(dev),
            "methodology": (
                "vs_baseline = the CPU baseline's time to 1e-2 on "
                "RND20000d16 (single-thread port of the reference hot "
                "loop, exps/ref_baseline.py) over this run's warm time to "
                "1e-2 on the same instance; warm-up excluded on both "
                "sides. The G1-shaped graph has no baseline of its own. "
                "device_al_iters_per_sec is the slope between two inner-"
                "loop launch lengths, timed with CUDA events."),
            "maxcut_G1_shaped": g1,
            "maxcut_n20000": d20k,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
