"""Experiment CLI of the port: the JAX package's ``exps/run.py``, a
mirror of the reference's benchmark driver (reference: exps/test.jl:1-210).

    python -m sdplrplus_tpu_torch.exps.run --graph G1 --problem MaxCut \\
        --ptol 1e-2 --objtol 1e-2 [--device cpu]

Protocol (reference: exps/test.jl:176-210): load the .mat adjacency (or
build a seeded synthetic graph), run one warm-up solve at the real
tolerances, then the timed solve; apply the problem's rounding callback
on the solve's device; write one JSON result per (problem, graph), and a
``_state.npz`` of the dual multipliers for ``exps/certify.py``. The
solve runs on the card unless ``--device cpu`` is given; every artifact
names the device it ran on. ``main(argv)`` returns the timed result.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import sys

import numpy as np

from .common import OUTPUT, setup_cache, short_result

PROBLEMS = ["MaxCut", "MinimumBisection", "LovaszTheta", "CutNorm",
            "MuConductance"]


def parse_args(argv=None):
    from ..utils.io import DATA_ROOT

    p = argparse.ArgumentParser(
        description="SDPLRPlus benchmark driver (PyTorch/CUDA port)")
    p.add_argument("--graph", type=str, default="G1")
    p.add_argument("--ptol", type=float, default=1e-2)
    p.add_argument("--objtol", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rank", type=int, default=10)
    p.add_argument("--problem", type=str, default="MaxCut", choices=PROBLEMS)
    p.add_argument("--dtype", type=str, default=None,
                   help="float32 (also when omitted) or float64")
    p.add_argument("--maxtime", type=float, default=36000.0)
    p.add_argument("--data-root", type=str, default=DATA_ROOT)
    p.add_argument("--output", type=str,
                   default=os.path.join(OUTPUT, "_live"),
                   help="default is the gitignored _live tree so ad-hoc "
                        "reruns never dirty committed artifacts")
    p.add_argument("--skip-warmup", action="store_true")
    p.add_argument("--mu", type=float, default=0.1,
                   help="conductance volume fraction for MuConductance "
                        "(reference: exps/problems.jl:295-341)")
    p.add_argument("--synthetic-n", type=int, default=0,
                   help="solve a seeded synthetic graph of this size "
                        "instead of a Gset .mat")
    p.add_argument("--synthetic-kind", type=str, default="random",
                   choices=["random", "local", "cyclepow", "cliques"],
                   help="random: G(n,M)-style; local: ring-local "
                        "(window = 4*deg); cyclepow: cycle power C_n^deg "
                        "with analytic Lovász number n/(deg+1); cliques: "
                        "n/deg disjoint deg-cliques with analytic "
                        "Lovász number n/deg")
    p.add_argument("--deg", type=int, default=16,
                   help="average degree of the synthetic graph")
    p.add_argument("--devices", type=int, default=1,
                   help="ranks to row-shard the solve over: one card "
                        "each under NCCL on cuda, gloo processes on the "
                        "cpu (workers are started for the solve)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the solve and the rounding: "
                        "cuda (default; fails without a card) or cpu")
    return p.parse_args(argv)


def synthetic_instance(kind: str, n: int, deg: int):
    """The CLI's seeded synthetic graphs (``--synthetic-kind``)."""
    from ..models import (
        synthetic_cliques, synthetic_cycle_power, synthetic_graph,
        synthetic_local_graph,
    )

    if kind == "cyclepow":
        return synthetic_cycle_power(n, deg)
    if kind == "cliques":
        return synthetic_cliques(n, deg)
    if kind == "local":
        return synthetic_local_graph(n, deg, 4 * deg)
    return synthetic_graph(n, deg)


def load_graph(args, graph: str, problem: str):
    """The adjacency of ``graph``: the synthetic instance when
    ``--synthetic-n`` is set, else the Gset .mat under ``--data-root``
    (MuConductance runs on the MaxCut adjacencies, as the reference keeps
    no data directory for it). Exits with the available names when the
    file is missing."""
    from ..utils.io import gset_path, load_mat_adjacency

    if args.synthetic_n:
        return synthetic_instance(args.synthetic_kind, args.synthetic_n,
                                  args.deg)
    data_problem = "MaxCut" if problem == "MuConductance" else problem
    path = gset_path(graph, problem=data_problem, root=args.data_root)
    if not os.path.exists(path):
        have = sorted(
            os.path.splitext(os.path.basename(p))[0]
            for p in glob.glob(os.path.join(args.data_root, data_problem,
                                            "*.mat")))
        sys.exit(f"error: unknown graph '{graph}' for {problem} (no file "
                 f"{path}). Available: {', '.join(have) or 'none'}")
    return load_mat_adjacency(path)


def problem_spec(problem: str, mu: float, device):
    """(builder, rounding callback, trace bound(n, A)) of a problem family,
    with the rounding on ``device``."""
    from ..models import (
        cutnorm, lovasz_theta, maxcut, minimum_bisection,
        mu_conductance_ineq, mu_conductance_ub,
    )
    from ..utils.rounding import (
        dummy_callback, maxcut_rounding, minimum_bisection_rounding,
    )

    def mu_tb(n, A):
        # X_ii <= ub per inequality constraint -> trace <= n*ub
        return float(n) * mu_conductance_ub(float(np.asarray(A.sum())), mu)

    n_tb = lambda n, A: float(n)
    return {
        "MaxCut": (maxcut, functools.partial(maxcut_rounding,
                                             device=device), n_tb),
        "MinimumBisection": (
            minimum_bisection,
            functools.partial(minimum_bisection_rounding, device=device),
            n_tb),
        "LovaszTheta": (lovasz_theta, dummy_callback, lambda n, A: 1.0),
        "CutNorm": (cutnorm, dummy_callback, n_tb),
        "MuConductance": (lambda A: mu_conductance_ineq(A, mu),
                          dummy_callback, mu_tb),
    }[problem]


def run_one(args, graph: str, A, filename: str, ptol: float, objtol: float,
            printlevel: int = 1, **solver_kw) -> dict:
    """One solve of ``args.problem`` on ``A`` through ``sdplr`` on
    ``args.device``, its rounding, and its artifacts
    ``<output>/<problem>/<graph>/<filename>.json`` (and ``_state.npz``
    unless a warm-up); the result carries the JSON's path as
    ``artifact``. ``solver_kw`` go to ``sdplr`` as they are (e.g.
    ``rank_update_mode``). Under a process group only its coordinator
    writes the artifacts and prints."""
    from .. import sdplr
    from ..parallel.multihost import is_coordinator

    builder, callback, tb = problem_spec(args.problem, args.mu, args.device)
    n = A.shape[0]
    out = builder(A)
    C, As, b = out[:3]
    ct = out[3] if len(out) == 4 else None
    res = sdplr(
        C, As, b, args.rank,
        constraint_types=ct,
        prior_trace_bound=tb(n, A),
        dataset=graph,
        seed=args.seed,
        ptol=ptol,
        objtol=objtol,
        maxtime=args.maxtime,
        dtype=args.dtype,
        devices=args.devices,
        device=args.device,
        printlevel=printlevel,
        **solver_kw,
    )
    res["callback_res"] = callback(A, res["R"])
    short = short_result(res, problem=args.problem, graph=graph, n=n,
                         seed=args.seed, maxtime=args.maxtime,
                         device=args.device)
    outdir = os.path.join(args.output, args.problem, graph)
    path = os.path.join(outdir, filename + ".json")
    if not is_coordinator():    # every rank of a process group runs this
        res["artifact"] = path
        return res
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(short, f, indent=4, default=float)
    if "warmup" not in filename:
        # dual-multiplier state for independent certification
        # (exps/certify.py): rebuild S(y) on the host in float64 and
        # cross-check the solver's Lanczos bound with scipy eigsh
        np.savez_compressed(
            os.path.join(outdir, filename + "_state.npz"),
            best_lam=np.asarray(res["lambda"], np.float64),
            lam_last=np.asarray(res["lambda_last"], np.float64),
            R=np.asarray(res["R"], np.float32),
            obj=res["obj"],
            obj_feasible=(np.nan if res.get("obj_feasible") is None
                          else res["obj_feasible"]),
            max_dual_value=res["max_dual_value"],
            rel_duality_gap=res["rel_duality_gap"],
            trace_bound=tb(n, A),
        )
    print(f"[{args.problem}/{graph}] obj={res['obj']:.6f} "
          f"pinfeas={res['primal_vio']:.2e} gap={res['rel_duality_gap']:.2e} "
          f"time={res['totaltime']:.2f}s iters={res['iter']} "
          f"engine={res['inner_engine']} device={short['device']} -> {path}",
          flush=True)
    res["artifact"] = path
    return res


def artifact_name(args) -> str:
    return f"SDPLRTORCH-R-{args.rank}-seed-{args.seed}-tol-{args.ptol}"


def main(argv=None) -> dict:
    args = parse_args(argv)
    setup_cache()
    A = load_graph(args, args.graph, args.problem)
    if not args.skip_warmup:
        # warm-up at the REAL tolerances (not the reference's tol=1.0,
        # exps/test.jl:185), so that it walks the same rank-doubling and
        # Lanczos ladder as the timed run. It pays for what the timed run
        # must not: the nvcc build of the kernels at first use (cached in
        # the build directory afterwards), the CUDA-graph capture of the
        # entry-mask step at each rank, and the start-up of cuBLAS,
        # cuSPARSE and the caching allocator.
        run_one(args, args.graph, A, "SDPLRTORCH-warmup", args.ptol,
                args.objtol)
    return run_one(args, args.graph, A, artifact_name(args), args.ptol,
                   args.objtol)


if __name__ == "__main__":
    main()
