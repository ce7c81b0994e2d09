"""Diagnose the μ-conductance dual bound: three dual bounds at the final
iterate of a μ-conductance solve.

Counterpart of the JAX package's ``exps/diag_mucond.py``. After a short
solve (on the card unless ``--device cpu``) it evaluates, in float64:

  (a) the AL-iterate multiplier y = −min(λ_ub, λ) at the solve's last
      λ (0 caps the inequalities), with the exact λ_min of
      S(y) = C + Σ yᵢAᵢ (dense ``eigvalsh``);
  (b) the generalized least-squares multiplier of the solver
      (solver/dualbound.ls_dual_head) with the solver's own safeguarded
      Lanczos (solver/dualbound.dual_obj, the LS path) on the solve's
      device;
  (c) the generalized least-squares multiplier computed densely here
      (``dual_value_mucond``: ‖S(y)R‖_F minimized over every dual degree
      of freedom, the ddᵀ multiplier in closed form by per-row
      projection, the diagonal totals split between the volume and the
      box multipliers by a 1-D concave piecewise-linear maximization)
      with the exact λ_min,

so (b) against (c) isolates the eigensolve and (a) against (c) the
multiplier. Every bound is −⟨y, b⟩ + tb·min(λ_min, 0), tb = n·ub.

    python -m sdplrplus_tpu_torch.exps.diag_mucond [--graph G1 |
        --synthetic-n 800 --deg 24] [--mu 0.1] [--maxtime 60] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import scipy.sparse as sp

from .common import setup_cache


def dual_value_mucond(L, d, volG, mu, R, tb, y2=None):
    """Generalized LS dual bound of the μ-conductance family, dense
    float64: S(y) = L + y1·D + y2·ddᵀ + diag(z), z free (the upper/lower
    box multipliers), b = [1, 0, ub·1, −lb·1]. Returns (dual, lam_min,
    y1, y2, w)."""
    from ..models import mu_conductance_lb, mu_conductance_ub

    n = L.shape[0]
    ub = mu_conductance_ub(volG, mu)
    lb = mu_conductance_lb(volG, mu)

    U = L @ R                        # (n, r)
    V = np.outer(d, d @ R) if y2 is None else None
    nrm = np.maximum(np.sum(R * R, axis=1), 1e-300)

    def rowproj(M):
        return M - (np.sum(M * R, axis=1) / nrm)[:, None] * R

    if y2 is None:
        PU, PV = rowproj(U), rowproj(V)
        denom = np.sum(PV * PV)
        y2 = -float(np.sum(PU * PV) / denom) if denom > 1e-300 else 0.0
    M = U + y2 * np.outer(d, d @ R)
    w = -np.sum(M * R, axis=1) / nrm   # optimal per-row diagonal total

    # split w_i = y1·d_i + z_i maximizing −y1 − ub·Σ z⁺ + lb·Σ z⁻ (concave
    # piecewise-linear in y1; the optimum sits at a breakpoint w_i/d_i)
    t = w / d
    order = np.argsort(t)
    ts, ds = t[order], d[order]
    suf = np.concatenate([np.cumsum(ds[::-1])[::-1], [0.0]])  # Σ_{i>=k} d
    pre = np.concatenate([[0.0], np.cumsum(ds)])              # Σ_{i<k} d
    gp = -1.0 + ub * suf + lb * pre    # the slope just below breakpoint k
    k = int(np.searchsorted(-gp, 0.0))  # the first k with gp <= 0
    y1 = float(ts[min(k, n - 1)])
    z = w - y1 * d
    lin = -y1 - ub * np.sum(np.maximum(z, 0)) + lb * np.sum(
        np.maximum(-z, 0))

    S = L.toarray() + y1 * np.diag(d) + y2 * np.outer(d, d) + np.diag(z)
    lam_min = float(np.linalg.eigvalsh(S)[0])
    dual = lin + tb * min(lam_min, 0.0)
    return dual, lam_min, y1, y2, w


def al_dual_dense(C, As, b, y, tb):
    """(dual, lam_min) at multiplier y: −⟨y, b⟩ + tb·min(λ_min(S), 0) with
    S = C + Σ yᵢAᵢ assembled densely in float64."""
    from ..problem import SymLowRank, as_operand

    def dense(A, n):
        A = as_operand(A, n)
        if isinstance(A, SymLowRank):
            return (A.B * A.d[None, :]) @ A.B.T
        return sp.coo_matrix((A.vals, (A.rows, A.cols)),
                             shape=(n, n)).toarray()

    n = as_operand(C).n
    S = dense(C, n)
    for yi, Ai in zip(y, As):
        if yi != 0.0:
            S = S + yi * dense(Ai, n)
    S = 0.5 * (S + S.T)
    lam_min = float(np.linalg.eigvalsh(S)[0])
    return -float(np.dot(y, b)) + tb * min(lam_min, 0.0), lam_min


def solver_ls_dual(C, As, b, ct, R, lam, tb, device, dtype, seed=0):
    """(dual, lam_min) of the solver's least-squares multiplier and its
    safeguarded Lanczos at the factor R, on ``device``."""
    import torch

    from ..compile import compile_problem
    from ..config import resolve_dtype, SolverConfig
    from ..ops.device import to_device
    from ..problem import SDPProblem
    from ..solver.dualbound import dual_obj

    prob = SDPProblem(C, list(As), np.asarray(b, np.float64), ct)
    cp = compile_problem(prob)
    tdt = resolve_dtype(SolverConfig(dtype=dtype))
    dp = to_device(cp, tdt, device)
    Rp = np.zeros((cp.n_pad, R.shape[1]))
    Rp[: cp.n] = R
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=tdt, device=dp.device)
    gen = torch.Generator().manual_seed(int(seed))
    dual, lam_min, _ = dual_obj(
        dp, t(lam), t(0.0), torch.zeros(cp.m + 1, dtype=tdt,
                                        device=dp.device),
        float(tb), 1000, gen, R=t(Rp))
    return float(dual), float(lam_min)


def main(argv=None) -> dict:
    from ..utils.io import DATA_ROOT

    p = argparse.ArgumentParser()
    p.add_argument("--graph", default="G1")
    p.add_argument("--synthetic-n", type=int, default=0,
                   help="solve the CLI's seeded random graph of this size")
    p.add_argument("--deg", type=int, default=16)
    p.add_argument("--mu", type=float, default=0.1)
    p.add_argument("--maxtime", type=float, default=60.0)
    p.add_argument("--rank", type=int, default=10)
    p.add_argument("--dtype", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--data-root", default=DATA_ROOT)
    args = p.parse_args(argv)
    setup_cache()

    from .. import sdplr
    from ..models import mu_conductance_ineq, mu_conductance_ub
    from ..models.problems import _laplacian
    from .run import load_graph

    args.synthetic_kind = "random"
    graph = f"SYN{args.synthetic_n}" if args.synthetic_n else args.graph
    A = load_graph(args, graph, "MuConductance")
    n = A.shape[0]
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    volG = float(d.sum())
    tb = n * mu_conductance_ub(volG, args.mu)

    C, As, b, ct = mu_conductance_ineq(A, args.mu)
    res = sdplr(C, As, b, args.rank, constraint_types=ct,
                prior_trace_bound=tb, ptol=1e-2, objtol=1e-2,
                maxtime=args.maxtime, dtype=args.dtype, dataset=graph,
                device=args.device, printlevel=1)
    R = np.asarray(res["R"], np.float64)
    lam_last = np.asarray(res["lambda_last"], np.float64)
    lam_ub = np.where(np.asarray(ct, bool), 0.0, np.inf)
    print(f"\nsolver: obj={res['obj']:.6f} vio={res['primal_vio']:.2e} "
          f"max_dual={res['max_dual_value']:.6f} "
          f"gap={res['rel_duality_gap']:.3f} iters={res['iter']} "
          f"engine={res['inner_engine']}")

    dual_a, lmin_a = al_dual_dense(C, As, b, -np.minimum(lam_ub, lam_last),
                                   tb)
    print(f"(a) AL-iterate dual, exact eig:   dual={dual_a:.6f} "
          f"lam_min={lmin_a:.4e}")
    dual_b, lmin_b = solver_ls_dual(C, As, b, ct, R, lam_last, tb,
                                    args.device, args.dtype)
    print(f"(b) LS multiplier, solver Lanczos: dual={dual_b:.6f} "
          f"lam_min={lmin_b:.4e}")
    dual_c, lmin_c, y1, y2, _ = dual_value_mucond(
        _laplacian(A), d, volG, args.mu, R, tb)
    print(f"(c) LS multiplier, exact eig:     dual={dual_c:.6f} "
          f"lam_min={lmin_c:.4e} y1={y1:.4f} y2={y2:.4f}")
    obj = float(res["obj"])
    out = dict(graph=graph, n=n, obj=obj, solver_max_dual=float(
        res["max_dual_value"]), dual_a=dual_a, dual_b=dual_b, dual_c=dual_c,
        lam_min_a=lmin_a, lam_min_b=lmin_b, lam_min_c=lmin_c,
        iter=int(res["iter"]), inner_engine=res["inner_engine"],
        timed_out=bool(res["timed_out"]))
    for tag in ("a", "b", "c"):
        dv = out[f"dual_{tag}"]
        out[f"gap_{tag}"] = (obj - dv) / max(min(abs(obj), abs(dv)), 1e-12)
        print(f"    gap vs ({tag}): {out[f'gap_{tag}']:.4f}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
