"""Entrywise dense-mask operators: the inner-loop math of single-entry
constraint families (Lovász θ) as matmuls and masked reductions.

Counterpart of the JAX package's ``ops/entrymask.py``.
When every narrow constraint touches exactly one upper-triangular
position (θ's edge constraints X_ij = 0, reference: test/problem.jl:43-65),
the per-constraint vectors are laid out as dense masked (n_pad, n_pad)
matrices:

  * violations v_e -> v_ew[i,j] = v_e at the entry's two symmetric
    positions (0 elsewhere); multipliers λ_e -> Λ_ew likewise;
  * the entry part of S = Σ yᵢAᵢ is the elementwise ew_v1 ∘ (σ·v_ew − Λ_ew);
  * the line-search products 𝒜(RDᵀ+DRᵀ) and 𝒜(DDᵀ) are ew_c2 ∘ (RDᵀ+DRᵀ)
    and ew_c2 ∘ DDᵀ, two n²r matmuls;
  * every quartic-coefficient dot over constraints Σₑ aₑbₑ is the masked
    reduction Σ H ∘ a_ew ∘ b_ew with H = ½ off the diagonal, 1 on it (an
    off-diagonal constraint appears at both symmetric positions).

Wide diagonal constraints (θ's trace) and low-rank constraints stay as a
small "extra" slot vector. The m-vector is materialized only at chunk and
major boundaries (``entry_split`` / ``entry_merge``), never inside the
inner loop. Equality-only: compile.py enforces eligibility.

On a rank-local problem (``dp.spmd``) every (n_pad, n_pad) mask and the
carried v_ew / Λ_ew hold this rank's row block (n_loc, n_pad). The left
factor of every matmul is the local row block and the right factor the
all-gathered matrix (``_full_rows``), so RDᵀ + DRᵀ needs no transpose of
a sharded array; masked reductions are summed across ranks (``_psum``);
the per-entry scatters and gathers keep the rows this rank owns
(``_row_offset``). On one device the three helpers are identities.
Every contraction here is a full-precision FP32 (or FP64) matmul: TF32
stays off (ROADMAP §2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.comm import dp_full as _full_rows
from ..parallel.comm import dp_psum as _psum
from ..parallel.comm import row_offset as _row_offset
from .cubic import minimize_quartic
from .device import DeviceProblem


def entry_enabled(dp: DeviceProblem) -> bool:
    return dp.ew_c2 is not None


def _idx(dp: DeviceProblem, gids) -> torch.Tensor:
    return torch.tensor(gids, dtype=torch.int64, device=dp.device)


def _local(dp: DeviceProblem, rows: torch.Tensor, n_loc: int):
    """(local row ids clipped into the block, which of them this rank
    owns) for global rows."""
    lr = rows - _row_offset(dp)
    valid = (lr >= 0) & (lr < n_loc)
    return torch.clamp(lr, 0, n_loc - 1), valid


def _scatter_sym(dp: DeviceProblem, base, vals):
    """Add per-entry values at (rows, cols) and at the mirrored positions
    (a diagonal entry only once), into the rows this rank holds."""
    n_loc = base.shape[0]
    zero = torch.zeros_like(vals)

    def scat(M, rows, cols, v):
        lr, valid = _local(dp, rows, n_loc)
        return M.index_put((lr, cols), torch.where(valid, v, zero),
                           accumulate=True)

    M = scat(base, dp.entry_rows, dp.entry_cols, vals)
    offdiag = dp.entry_rows != dp.entry_cols
    return scat(M, dp.entry_cols, dp.entry_rows,
                torch.where(offdiag, vals, zero))


def _n_extra_wide(dp: DeviceProblem) -> int:
    return 0 if dp.extra_wide_w is None else dp.extra_wide_w.shape[0]


def _extra_lowrank(dp: DeviceProblem):
    """Low-rank constraint terms (gid != m) paired with their slot in the
    extras vector (extras order: wide first, then low-rank by gid)."""
    nw = _n_extra_wide(dp)
    by_gid = {t.gid: t for t in dp.lowrank if t.gid != dp.m}
    return [(nw + i, by_gid[g]) for i, g in enumerate(dp.extra_gids[nw:])]


def _lowrank_apply(dp: DeviceProblem, t, X):
    """B·(d ⊙ BᵀX) for one low-rank term (BᵀX summed across ranks)."""
    return t.B @ (t.d[:, None] * _psum(t.B.T @ X, dp))


# --------------------------------------------------------------------------
# m-vector <-> dense-mask conversions (chunk and major boundaries only)
# --------------------------------------------------------------------------

def entry_split(dp: DeviceProblem, vio_raw: torch.Tensor):
    """(m+1,) raw violations -> (v_ew [n_pad, n_pad], v_ex [n_ex], obj)."""
    v = vio_raw[: dp.m]
    v_ew = _scatter_sym(dp, torch.zeros_like(dp.ew_c2), v[dp.entry_gids])
    v_ex = v[_idx(dp, dp.extra_gids)]
    return v_ew, v_ex, vio_raw[dp.m]


def entry_merge(dp: DeviceProblem, v_ew, v_ex, obj) -> torch.Tensor:
    """Inverse of entry_split -> (m+1,) with slot m = obj."""
    lr, valid = _local(dp, dp.entry_rows, v_ew.shape[0])
    ve = v_ew[lr, dp.entry_cols]
    ve = _psum(torch.where(valid, ve, torch.zeros_like(ve)), dp)
    vals = torch.zeros(dp.m + 1, dtype=v_ew.dtype, device=v_ew.device)
    vals[dp.entry_gids] = ve
    vals[_idx(dp, dp.extra_gids)] = v_ex
    vals[dp.m] = obj
    return vals


def entry_lam(dp: DeviceProblem, lam: torch.Tensor):
    """λ (m,) -> (Λ_ew [n_pad, n_pad], lam_ex [n_ex]), fixed within a major
    iteration."""
    L = _scatter_sym(dp, torch.zeros_like(dp.ew_c2, dtype=lam.dtype),
                     lam[dp.entry_gids])
    return L, lam[_idx(dp, dp.extra_gids)]


# --------------------------------------------------------------------------
# inner-loop operators
# --------------------------------------------------------------------------

def apply_C_entry(dp: DeviceProblem, X: torch.Tensor) -> torch.Tensor:
    """C @ X: a dense matmul for sparse C, a tall-skinny contraction for
    low-rank C (the gid == m term)."""
    out = (dp.ew_C @ _full_rows(dp, X) if dp.ew_C is not None
           else torch.zeros_like(X))
    for t in dp.lowrank:
        if t.gid == dp.m:
            out = out + _lowrank_apply(dp, t, X)
    return out


def gradient_entry(dp: DeviceProblem, R, CR, v_ew, v_ex, Lam_ew, lam_ex,
                   sigma) -> torch.Tensor:
    """G = 2·S·R with S = C + Σ yᵢAᵢ, y = -(λ - σv) (equality form of
    reference src/coreop.jl:229-317). The entry part of S is the
    elementwise ew_v1 ∘ (σ·v_ew − Λ_ew); CR = C@R is kept by the caller
    (one matmul per line search serves the slope and this term)."""
    S_ew = dp.ew_v1 * (sigma * v_ew - Lam_ew)
    G = S_ew @ _full_rows(dp, R) + CR
    nw = _n_extra_wide(dp)
    y_ex = -(lam_ex - sigma * v_ex)
    if nw:
        G = G + (y_ex[:nw] @ dp.extra_wide_w)[:, None] * R
    for idx, t in _extra_lowrank(dp):
        G = G + y_ex[idx] * _lowrank_apply(dp, t, R)
    return 2.0 * G


class EntryLS(NamedTuple):
    alpha: torch.Tensor
    L_new: torch.Tensor
    v_ew: torch.Tensor
    v_ex: torch.Tensor
    obj: torch.Tensor
    CD: torch.Tensor  # C @ D, for the caller's incremental CR update


def linesearch_entry(dp: DeviceProblem, R, D, v_ew, v_ex, obj, Lam_ew,
                     lam_ex, sigma, alpha_max=1.0) -> EntryLS:
    """Exact quartic line search in dense-mask form (reference:
    src/linesearch.jl:4-127). q1 = 𝒜(RDᵀ+DRᵀ) = ew_c2 ∘ (RDᵀ+DRᵀ) and
    q2 = 𝒜(DDᵀ) = ew_c2 ∘ DDᵀ; the coefficient dots over constraints are
    the masked Grams Σ H ∘ a ∘ b of (Λ, v, q1, q2), one matmul, plus the
    extras' dots. The step is committed algebraically like the reference
    (src/linesearch.jl:114-126)."""
    if dp.spmd is None:
        RD = R @ D.T
        RD = RD + RD.T
        D_full = D
    else:
        # the local row block of RDᵀ + DRᵀ: row i is Rᵢ·D_fullᵀ + Dᵢ·R_fullᵀ
        D_full = _full_rows(dp, D)
        RD = R @ D_full.T + D @ _full_rows(dp, R).T
    q1_ew = dp.ew_c2 * RD                           # 𝒜(RDᵀ+DRᵀ)
    q2_ew = dp.ew_c2 * (D @ D_full.T)               # 𝒜(DDᵀ)

    # extras: wide diagonal constraints are row-sum reductions, low-rank
    # constraints tall-skinny contractions
    nw = _n_extra_wide(dp)
    n_ex = len(dp.extra_gids)
    q1_ex = torch.zeros(n_ex, dtype=R.dtype, device=R.device)
    q2_ex = torch.zeros(n_ex, dtype=R.dtype, device=R.device)
    if nw:
        q1_ex[:nw] = _psum(dp.extra_wide_w @ (2.0 * torch.sum(R * D, dim=1)),
                           dp)
        q2_ex[:nw] = _psum(dp.extra_wide_w @ torch.sum(D * D, dim=1), dp)
    for idx, t in _extra_lowrank(dp):
        rb = _psum(R.T @ t.B, dp)
        db = _psum(D.T @ t.B, dp)
        q1_ex[idx] = 2.0 * torch.sum(t.d * torch.sum(rb * db, dim=0))
        q2_ex[idx] = torch.sum(t.d * torch.sum(db * db, dim=0))

    # objective slope terms: one product CD serves p1, p2 and the
    # caller's incremental CR update
    CD = apply_C_entry(dp, D)
    p1 = 2.0 * _psum(torch.sum(R * CD), dp)
    p2 = _psum(torch.sum(D * CD), dp)

    # masked Gram of (Λ, v, q1, q2) (summed across ranks) and the
    # extras' one
    M = torch.stack([Lam_ew, v_ew, q1_ew, q2_ew]).reshape(4, -1)
    Gm = _psum((M * dp.ew_h.reshape(1, -1)) @ M.T, dp)
    X4 = torch.stack([lam_ex, v_ex, q1_ex, q2_ex])
    Gm = Gm + X4 @ X4.T
    L_, V_, Q1, Q2 = 0, 1, 2, 3

    # quartic coefficients (reference: src/linesearch.jl:20-56)
    e = obj - Gm[L_, V_] + sigma * Gm[V_, V_] / 2.0
    d1 = p1 - Gm[L_, Q1] + sigma * Gm[V_, Q1]
    c1 = (p2 - (Gm[L_, Q2] - sigma * Gm[V_, Q2])
          + sigma * Gm[Q1, Q1] / 2.0)
    b1 = sigma * Gm[Q1, Q2]
    a1 = sigma * Gm[Q2, Q2] / 2.0

    alpha, f_star = minimize_quartic((e, d1, c1, b1, a1), alpha_max)
    return EntryLS(
        alpha=alpha, L_new=f_star,
        v_ew=v_ew + alpha * (alpha * q2_ew + q1_ew),
        v_ex=v_ex + alpha * (alpha * q2_ex + q1_ex),
        obj=obj + alpha * (alpha * p2 + p1),
        CD=CD,
    )


def assemble_S_dense(dp: DeviceProblem, y_full: torch.Tensor) -> torch.Tensor:
    """Dense S = Σᵢ yᵢAᵢ + y_m·C for the Lanczos matvec, built once per
    dual bound (y scattered to the entry positions, elementwise weights,
    rank-s updates); each Lanczos step is then one matvec."""
    Y = _scatter_sym(dp, torch.zeros_like(dp.ew_c2, dtype=y_full.dtype),
                     y_full[dp.entry_gids])
    S = dp.ew_v1 * Y
    if dp.ew_C is not None:
        S = S + y_full[dp.m] * dp.ew_C
    nw = _n_extra_wide(dp)
    if nw:
        # the local rows' diagonal entries sit at (i, i + row offset)
        y_exw = y_full[_idx(dp, dp.extra_gids[:nw])]
        i_loc = torch.arange(S.shape[0], device=S.device)
        S = S.index_put((i_loc, i_loc + _row_offset(dp)),
                        y_exw @ dp.extra_wide_w, accumulate=True)
    for t in dp.lowrank:
        S = S + y_full[t.gid] * ((t.B * t.d[None, :])
                                 @ _full_rows(dp, t.B).T)
    return S


def vio_norm_entry(dp: DeviceProblem, v_ew, v_ex, pscale) -> torch.Tensor:
    """‖v‖₂ over constraints (equality-only: no capping, reference:
    src/coreop.jl:22)."""
    sq = _psum(torch.sum(dp.ew_h * v_ew * v_ew), dp) + torch.dot(v_ex, v_ex)
    return torch.sqrt(sq) / pscale


# --------------------------------------------------------------------------
# least-squares dual multiplier (masked-matrix CG)
# --------------------------------------------------------------------------

def ls_dual_entry(dp: DeviceProblem, R, n_cg: int = 25):
    """Least-squares dual multiplier of the entry-mode families, the θ
    analog of solver/dualbound.ls_dual_head: minimizes ‖S(y)·R‖_F over all
    dual variables, the edge multipliers as a masked symmetric matrix Z
    (Z_ij = v_ij·y_ij on the entry support), the extras as a small vector
    a, by ``n_cg`` steps of CGNR whose operator applications are matmuls:

        A(Z, a)  = Z@R + Σ_w a_w·diag(w)R + Σ_t a_t·B d Bᵀ R
        Aᵀ(res)  = (mask ⊙ sym(res·Rᵀ), [⟨diag(w)R, res⟩], [⟨BdBᵀR, res⟩])

    Any y is dual-feasible for θ (every constraint is an equality), so
    the bound at the CG solution is valid. Returns y_head (m,). No
    reference counterpart (the reference evaluates only the AL ascent
    iterate, src/coreop.jl:376-415)."""
    dtype = R.dtype
    mask = (dp.ew_h != 0).to(dtype)               # entry support, local rows
    R_f = _full_rows(dp, R)
    nw = _n_extra_wide(dp)
    lr_terms = _extra_lowrank(dp)
    n_ex = nw + len(lr_terms)
    tiny = torch.finfo(dtype).tiny

    # the extras' fixed factors W_e R, each (n_pad, r)
    WR = [dp.extra_wide_w[e][:, None] * R for e in range(nw)]
    WR += [_lowrank_apply(dp, t, R) for _, t in lr_terms]

    def A_op(Z, a):
        out = Z @ R_f
        for e in range(n_ex):
            out = out + a[e] * WR[e]
        return out

    def At_op(res):
        if dp.spmd is None:
            P = res @ R.T
            P = P + P.T
        else:
            P = res @ R_f.T + R @ _full_rows(dp, res).T
        Zg = 0.5 * mask * P
        ag = (torch.stack([_psum(torch.sum(WR[e] * res), dp)
                           for e in range(n_ex)])
              if n_ex else torch.zeros(0, dtype=dtype, device=R.device))
        return Zg, ag

    def dot(u, w):
        return _psum(torch.sum(u[0] * w[0]), dp) + torch.dot(u[1], w[1])

    x = (torch.zeros_like(mask), torch.zeros(n_ex, dtype=dtype,
                                             device=R.device))
    r = At_op(-apply_C_entry(dp, R))              # b = -C·R
    p = r
    gamma = dot(r, r)
    for _ in range(n_cg):
        s = A_op(*p)
        alpha = gamma / torch.clamp(_psum(torch.sum(s * s), dp), min=tiny)
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        dZ, da = At_op(s)
        r = (r[0] - alpha * dZ, r[1] - alpha * da)
        gamma2 = dot(r, r)
        beta = gamma2 / torch.clamp(gamma, min=tiny)
        p = (r[0] + beta * p[0], r[1] + beta * p[1])
        gamma = gamma2
    Z, a = x

    # the per-entry multipliers y_e = Z_ij / v_ij (as entry_merge reads)
    lr, valid = _local(dp, dp.entry_rows, Z.shape[0])
    Zi = Z[lr, dp.entry_cols]
    vi = dp.ew_v1[lr, dp.entry_cols]
    vi = torch.where(valid & (vi != 0), vi, torch.ones_like(vi))
    ye = _psum(torch.where(valid, Zi, torch.zeros_like(Zi)) / vi, dp)
    y_head = torch.zeros(dp.m, dtype=dtype, device=R.device)
    y_head[dp.entry_gids] = ye
    y_head[_idx(dp, dp.extra_gids)] = a
    return y_head
