"""Independent float64 certification of an artifact of the port's CLI.

Counterpart of the JAX package's ``exps/certify.py``. It rebuilds
S(y) = Σᵢ yᵢAᵢ + C at the artifact's best dual multiplier ENTIRELY on the
host in float64 (scipy sparse + LinearOperator for low-rank terms,
``solver/dualrefine.build_S_operator``) and computes λ_min(S) with
scipy.sparse.linalg.eigsh — a code path that shares nothing with the
solver's device Lanczos. The certified dual value and duality gap are
then recomputed and compared with the artifact's. Host float64 is the
point of this script: it is the independent check, not a CPU fallback.

This is the independent-check practice of the reference (which
cross-validates every family against CSDP,
reference: exps/exp_csdp/exp_csdp.jl:1-221), applied to the solver's
own certificate: any y is dual-feasible by weak duality, so the float64
eigsh bound is valid regardless of how the solver derived y.

    python -m sdplrplus_tpu_torch.exps.certify --problem MaxCut \\
        --graph SYN20K --synthetic-n 20000 \\
        --artifact exps/output/_live/MaxCut/SYN20K/SDPLRTORCH-R-10-seed-0-tol-0.01.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import scipy.sparse.linalg as spla

from .run import PROBLEMS, load_graph, problem_spec


def parse_args(argv=None):
    from ..utils.io import DATA_ROOT

    p = argparse.ArgumentParser(description="independent f64 certification")
    p.add_argument("--artifact", type=str, required=True,
                   help="path to the run JSON; the _state.npz sidecar "
                        "written by exps/run.py must sit next to it")
    p.add_argument("--problem", type=str, default="MaxCut", choices=PROBLEMS)
    p.add_argument("--graph", type=str, default="G1")
    p.add_argument("--synthetic-n", type=int, default=0)
    p.add_argument("--synthetic-kind", type=str, default="random",
                   choices=["random", "cyclepow", "cliques", "local"],
                   help="same instance builders as exps/run.py")
    p.add_argument("--deg", type=int, default=16)
    p.add_argument("--mu", type=float, default=0.1)
    p.add_argument("--data-root", type=str, default=DATA_ROOT)
    p.add_argument("--tol", type=float, default=1e-7,
                   help="eigsh convergence tolerance")
    p.add_argument("--refine-k", type=int, default=64,
                   help="bottom-eigenvector basis size per refine pass")
    p.add_argument("--refine-lsqr", type=int, default=200,
                   help="LSQR iterations per refine pass")
    p.add_argument("--refine", type=int, default=0,
                   help="iterations of host-side f64 dual-multiplier "
                        "refinement (augmented-basis least squares, see "
                        "refine_dual) before certifying; 0 = certify "
                        "the solver's multiplier as-is")
    p.add_argument("--out", type=str, default=None,
                   help="output JSON (default: <artifact>_certify.json)")
    return p.parse_args(argv)


def load_instance(args):
    """(A, C, As, b, constraint_types) of the artifact's instance, built
    as the CLI builds it."""
    A = load_graph(args, args.graph, args.problem)
    builder = problem_spec(args.problem, args.mu, "cpu")[0]
    out = builder(A)
    C, As, b = out[:3]
    ct = out[3] if len(out) == 4 else None
    return A, C, As, np.asarray(b, np.float64), ct


def main(argv=None) -> dict:
    from ..solver.dualrefine import build_S_operator, refine_dual

    args = parse_args(argv)
    state_path = args.artifact.replace(".json", "_state.npz")
    with open(args.artifact) as f:
        art = json.load(f)
    state = np.load(state_path)
    best_lam = np.asarray(state["best_lam"], np.float64)
    tb = float(state["trace_bound"])
    obj_feas = float(state["obj_feasible"])
    obj = float(state["obj"])
    if not np.isfinite(obj_feas):
        obj_feas = obj

    _, C, As, b, ct = load_instance(args)
    # the solver stores best_lam = -y_head of the bound it certified
    y_head = -best_lam
    refine_hist = None
    if args.refine > 0:
        if ct is not None and np.any(ct):
            sys.exit("--refine supports equality-only problems")
        y_head, _, _, refine_hist = refine_dual(
            C, As, b, y_head, tb, iters=args.refine,
            k_eig=args.refine_k, lsqr_iters=args.refine_lsqr)
    S, n = build_S_operator(C, As, y_head)

    t0 = time.time()
    # eigsh on SA: plain Lanczos (no shift-invert — S is only available
    # as an operator); generous ncv for the clustered-near-zero spectrum
    w = spla.eigsh(S, k=1, which="SA", tol=args.tol,
                   maxiter=max(10000, 100 * int(np.sqrt(n))),
                   ncv=min(n - 1, 96), return_eigenvectors=False)
    lam_min = float(w[0])
    eig_time = time.time() - t0

    dual_f64 = float(-y_head @ b) + tb * min(lam_min, 0.0)
    denom = min(abs(obj_feas), abs(dual_f64))
    gap_f64 = (obj_feas - dual_f64) / denom if denom > 0 else float("inf")

    out = {
        "artifact": os.path.relpath(args.artifact),
        "problem": args.problem,
        "graph": args.graph,
        "n": n,
        "lam_min_f64": lam_min,
        "dual_f64": dual_f64,
        "trace_bound": tb,
        "obj": obj,
        "obj_feasible": obj_feas,
        "rel_duality_gap_f64": gap_f64,
        "solver_rel_duality_gap": art.get("rel_duality_gap"),
        "solver_max_dual": float(state["max_dual_value"]),
        "gap_ratio_f64_over_solver": (
            gap_f64 / art["rel_duality_gap"]
            if art.get("rel_duality_gap") else None
        ),
        "solver_device": art.get("device"),
        "eigsh_time_s": eig_time,
        "eigsh_tol": args.tol,
        "method": "scipy.sparse.linalg.eigsh(which='SA') on host f64"
                  + (f" after {args.refine} refine_dual iterations"
                     if args.refine else ""),
    }
    if refine_hist is not None:
        out["refine_history"] = refine_hist
    if (args.problem == "LovaszTheta" and args.synthetic_n
            and args.synthetic_kind in ("cyclepow", "cliques")):
        # analytic Lovász number of the synthetic instance (see the
        # generators in models/problems.py) — an EXACT independent
        # certificate for the primal objective
        theta = (args.synthetic_n / (args.deg + 1)
                 if args.synthetic_kind == "cyclepow"
                 else args.synthetic_n / args.deg)
        out["analytic_theta"] = theta
        out["primal_rel_err_vs_analytic"] = abs(-obj - theta) / theta
    out_path = args.out or args.artifact.replace(".json", "_certify.json")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=4, default=float)
    print(json.dumps(out, indent=2, default=float))
    print(f"-> {out_path}")
    return out


if __name__ == "__main__":
    main()
