"""Dual (suboptimality) bound and DIMACS error report.

Counterpart of the JAX package's ``solver/dualbound.py``: the Lanczos
suboptimality bound for trace-bounded SDPs (reference:
src/coreop.jl:376-415) and the six DIMACS error metrics
(src/coreop.jl:417-453).

    dual_value = -⟨y[0:m], b⟩ + trace_bound · min(λ_min(S), 0)

with y = [-min(λ_ub, λ - σv); 1] and S = Σ yᵢAᵢ + C, λ_min(S) from the
scalar Lanczos path (ops/lanczos.py) or the block path
(ops/blocklanczos.py). In entry mode (Lovász θ) S is assembled densely
once per bound (ops/entrymask.assemble_S_dense) and the least-squares
multiplier is the masked-matrix CG of ``ls_dual_entry``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.adjoint import apply_S, y_of
from ..ops.blocklanczos import block_lanczos_min_eig
from ..ops.device import DeviceProblem
from ..ops.entrymask import assemble_S_dense, entry_enabled, ls_dual_entry
from ..ops.lanczos import (
    bucket_q_max,
    lanczos_alpha_beta_impl,
    lanczos_alpha_beta_reorth_impl,
    lanczos_q,
    lanczos_v0,
    tridiag_min_eig,
    tridiag_min_eig_device_certified,
    tridiag_min_eig_resid,
)
from ..ops.spmm import spmm_C
from ..parallel.comm import dp_full, dp_psum


def ls_dual_head(dp: DeviceProblem, R, CR=None, y_fallback=None):
    """Generalized least-squares dual multiplier for all-diagonal
    constraint families (dp.ls_eligible): the y minimizing ‖S(y)R‖_F,
    then, among the minimizers, maximizing −⟨y,b⟩ (low-rank multipliers
    in closed form on the row-projected residuals; per-row diagonal
    totals; the wide/narrow split by a 1-D concave piecewise-linear
    maximization; z realized through the per-row channels). Any y is a
    valid dual (weak duality). ``CR`` optionally passes C_sparse @ R;
    ``y_fallback`` (m,) supplies multipliers for low-rank constraints
    whose direction range(R) cannot see. Returns y_head (m,). On a
    rank-local problem R and CR are this rank's rows: the low-rank
    products and the Grams are summed across ranks and the per-row
    totals all-gathered before the replicated split (JAX package:
    solver/dualbound.py:95-144)."""
    m = dp.m
    dtype, dev = R.dtype, R.device
    if CR is None:
        CR = spmm_C(dp, R)
    lr_cons = []
    for t in dp.lowrank:
        ApR = t.B @ (t.d[:, None] * dp_psum(t.B.T @ R, dp))
        if t.gid == m:
            CR = CR + ApR          # part of the objective C
        else:
            lr_cons.append((t.gid, ApR))

    den = torch.clamp(torch.sum(R * R, dim=1), min=torch.finfo(dtype).tiny)

    def rowproj(M):
        return M - (torch.sum(M * R, dim=1) / den)[:, None] * R

    y_lr = []
    if lr_cons:
        PU = rowproj(CR)
        PVs = [rowproj(V) for _, V in lr_cons]
        G = torch.stack([torch.stack([torch.sum(Va * Vb) for Vb in PVs])
                         for Va in PVs])
        h = torch.stack([torch.sum(Va * PU) for Va in PVs])
        Vn = torch.stack([torch.sum(V * V) for _, V in lr_cons])
        G, h, Vn = dp_psum(G, dp), dp_psum(h, dp), dp_psum(Vn, dp)
        eps = torch.finfo(dtype).eps
        # absolute floor keeps the solve nonsingular when every projected
        # direction vanishes; the blindness test below decides what to do
        delta = eps * (torch.trace(G) + 1.0)
        G = G + delta * torch.eye(len(PVs), dtype=dtype, device=dev)
        a = torch.linalg.solve(G, -h)
        for i, (gid, V) in enumerate(lr_cons):
            at = a[i]
            if y_fallback is not None:
                blind = G[i, i] <= 1e-6 * Vn[i]
                at = torch.where(blind, y_fallback[gid], at)
            CR = CR + at * V
            y_lr.append((gid, at))

    w = -torch.sum(CR * R, dim=1) / den
    # dead/padding rows: no LS information — leave their slack at zero
    alive = torch.sum(R * R, dim=1) > 0
    zero = torch.zeros((), dtype=dtype, device=dev)
    w = torch.where(alive, w, zero)
    if dp.spmd is not None:
        w = dp_full(dp, w)
        alive = dp_full(dp, alive.to(dtype)) > 0

    slope_p, slope_n = dp.ls_slope_pos, dp.ls_slope_neg
    gid_p, gid_n = dp.ls_gid_pos, dp.ls_gid_neg
    has_p, has_n = gid_p < m, gid_n < m

    if dp.ls_wide_gid >= 0:
        cw = dp.ls_cw
        active = (cw > 0) & alive
        sp_eff = torch.where(has_p, slope_p, zero)
        sn_eff = torch.where(has_n, slope_n, zero)
        inf = torch.full((), float("inf"), dtype=dtype, device=dev)
        t_bp = torch.where(active, w / torch.clamp(cw, min=1e-30), inf)
        drop = torch.where(active, (sn_eff - sp_eff) * cw, zero)
        b_w = dp.b[dp.ls_wide_gid]
        g0 = -b_w - torch.sum(torch.where(active, sp_eff * cw, zero))
        order = torch.argsort(t_bp, stable=True)
        gp_after = g0 - torch.cumsum(drop[order], dim=0)
        neg = gp_after <= 0
        idx = torch.argmax(neg.to(torch.int8))
        y_w = torch.where(neg.any(), t_bp[order][idx], zero)
        y_w = torch.where(torch.isfinite(y_w), y_w, zero)
        z = w - y_w * cw
    else:
        y_w = zero
        z = w

    # realize z through the per-row channels (clip to realizable sides)
    z = torch.where(z > 0, torch.where(has_p, z, zero),
                    torch.where(has_n, z, zero))
    gid = torch.where(z >= 0, gid_p, gid_n)
    v = torch.where(z >= 0, dp.ls_v_pos, dp.ls_v_neg)
    yv = torch.where(alive, z / v, zero)
    y_head = torch.zeros(m + 1, dtype=dtype, device=dev).index_add(
        0, gid, yv)[:m]
    if dp.ls_wide_gid >= 0:
        y_head[dp.ls_wide_gid] = y_w
    for gid_t, at in y_lr:
        y_head[gid_t] = at
    return torch.maximum(y_head, -dp.lam_ub)


def dual_obj(dp: DeviceProblem, lam, sigma, vio_raw, trace_bound: float,
             iter_count: int, generator: torch.Generator,
             highprecision: bool = False, safeguard: bool = True, R=None,
             v0=None, block: tuple | None = None,
             margin_target: float = 0.0, R_seed=None, k_min: int = 4,
             stats: dict | None = None):
    """Returns (dual_value, min_eig, y_full) (reference:
    src/coreop.jl:376-415). With ``safeguard`` the Lanczos Ritz value is
    corrected by its residual bound β_k·|s_k|. With ``R`` on an
    LS-eligible problem the bound is evaluated at the least-squares
    multiplier (solver/major.py's dual_bound). The Lanczos start vector is
    ``v0`` or a draw from ``generator``.

    ``block`` = (b, k_max) takes the block-Lanczos path: one b-lane
    operator pass per step, the start block seeded with ``R_seed`` (or
    ``R``), early exit once the certified margin drops below
    ``margin_target`` (λ units) and at least ``k_min`` steps (the
    caller's minimum Krylov depth). The block path is always
    residual-safeguarded. ``stats``, when given, receives the operator
    passes spent under ``"passes"`` (block steps on the block path,
    Lanczos steps on the scalar one)."""
    if R is not None and entry_enabled(dp):
        y_ls_head = ls_dual_entry(dp, R)
        return dual_obj(dp, -y_ls_head, torch.zeros_like(sigma),
                        torch.zeros_like(vio_raw), trace_bound, iter_count,
                        generator, highprecision=highprecision,
                        safeguard=safeguard, v0=v0, block=block,
                        margin_target=margin_target, R_seed=R,
                        k_min=k_min, stats=stats)
    if R is not None and dp.ls_eligible:
        y_al = -torch.minimum(dp.lam_ub, lam - sigma * vio_raw[: dp.m])
        y_ls_head = ls_dual_head(dp, R, y_fallback=y_al)
        # re-express as (lam, sigma=0, v=0): y = -min(lam_ub, lam)
        return dual_obj(dp, -y_ls_head, torch.zeros_like(sigma),
                        torch.zeros_like(vio_raw), trace_bound, iter_count,
                        generator, highprecision=highprecision,
                        safeguard=safeguard, v0=v0, block=block,
                        margin_target=margin_target, R_seed=R,
                        k_min=k_min, stats=stats)
    dtype = lam.dtype
    y_full = y_of(dp, lam, sigma, vio_raw)
    S_dense = assemble_S_dense(dp, y_full) if entry_enabled(dp) else None
    if block is not None and block[0] > 0:
        theta, margin, k_used = block_lanczos_min_eig(
            dp, y_full, generator, R_seed, margin_target, int(k_min),
            b=int(block[0]), k_max=int(block[1]), S_dense=S_dense)
        if stats is not None:
            stats["passes"] = int(k_used)
        min_eig = theta - margin
        yb = float(torch.dot(y_full[: dp.m], dp.b))
        return -yb + float(trace_bound) * min(min_eig, 0.0), min_eig, y_full
    if v0 is None:
        v0 = lanczos_v0(dp, generator, dtype)
    if highprecision:
        q_max = bucket_q_max(min(max(100, 2 * lanczos_q(iter_count, dp.n)),
                                 dp.n))
        alpha, beta, k_eff = lanczos_alpha_beta_reorth_impl(
            dp, y_full, v0, q_max=q_max, S_dense=S_dense)
    else:
        q = lanczos_q(iter_count, dp.n)
        q_max = bucket_q_max(q)
        alpha, beta, k_eff = lanczos_alpha_beta_impl(
            dp, y_full, v0, q, q_max=q_max, S_dense=S_dense)
    if stats is not None:
        stats["passes"] = int(k_eff)
    if safeguard:
        if q_max > 1024:
            theta, margin = tridiag_min_eig_resid(alpha, beta, k_eff)
        else:
            theta, margin = tridiag_min_eig_device_certified(
                alpha, beta, k_eff)
        min_eig = theta - margin
    else:
        min_eig = tridiag_min_eig(alpha, beta, k_eff)
    yb = float(torch.dot(y_full[: dp.m], dp.b))
    return -yb + float(trace_bound) * min(min_eig, 0.0), min_eig, y_full


def dimacs_errors(dp: DeviceProblem, R, lam, vio_raw, obj,
                  generator: torch.Generator) -> np.ndarray:
    """Six standard DIMACS error metrics (reference: src/coreop.jl:417-453).
    err2 = err3 = 0 by construction (X = RRᵀ ⪰ 0, Z = C - 𝒜ᵀλ). In entry
    mode S is assembled densely once for the Lanczos run and S·R. On a
    rank-local problem R is this rank's rows and ⟨R, S·R⟩ is summed
    across ranks."""
    m = dp.m
    normb = float(torch.linalg.norm(dp.b))
    err1 = float(torch.linalg.norm(vio_raw[:m])) / (1.0 + normb)
    # S with y = [-λ; 1] (reference: copy2y_λ!, src/coreop.jl:238-246)
    y_full = torch.cat([-lam, torch.ones(1, dtype=lam.dtype,
                                         device=lam.device)])
    S_dense = assemble_S_dense(dp, y_full) if entry_enabled(dp) else None
    q_max = bucket_q_max(min(100, dp.n))
    alpha, beta, k_eff = lanczos_alpha_beta_reorth_impl(
        dp, y_full, lanczos_v0(dp, generator, lam.dtype), q_max=q_max,
        S_dense=S_dense)
    min_eig, margin = tridiag_min_eig_resid(alpha, beta, k_eff)
    # conservative: under-estimate λ_min so err4 is never optimistic
    err4 = max(0.0, -(min_eig - margin)) / (1.0 + dp.normC)
    bty = float(torch.dot(lam, dp.b))
    obj = float(obj)
    err5 = (obj - bty) / (1.0 + abs(obj) + abs(bty))
    SR = (S_dense @ dp_full(dp, R) if S_dense is not None
          else apply_S(dp, y_full, R))
    err6 = float(dp_psum(torch.sum(R * SR), dp)) / (1.0 + abs(obj)
                                                     + abs(bty))
    return np.array([err1, 0.0, 0.0, err4, err5, err6])
