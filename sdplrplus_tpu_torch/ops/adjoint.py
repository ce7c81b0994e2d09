"""Adjoint operator 𝒜ᵀ: S = Σᵢ yᵢAᵢ + y_m·C applied to a dense factor
(the gradient G = 2·S·R and the Lanczos matvec S·v).

Counterpart of the JAX package's ``ops/adjoint.py``. When every
sparse-constraint entry lies on the diagonal,
S@X = y_m·(C@X) + diag(w·y)⊙X + Σ_t y_t·B_t(d_t ⊙ B_tᵀX), with C@X a
matmul (dense engine) or one ELL SpMM (fast-diagonal engine); the
``*_cx`` forms take C@X precomputed (the inner loop's carried CX).

With off-diagonal entries (Lovász θ) S is assembled at the aggregate
triu pattern (``assemble_s_tri``: each position gathers its few
constraint weights from y) and applied by one ELL SpMM whose values are
those of S looked up through ``ell_tri`` / ``ell2_tri`` (the general
``apply_S``; its row gather is ``gather_rows`` on the card).

An external model (``adapter.CustomModel``) supplies its own
``fn_apply_S``; ``apply_S`` and ``gradient`` dispatch to it first.

On a rank-local problem X and the result are this rank's row blocks; the
low-rank products BᵀX are summed across ranks and the general SpMM reads
the row support (ops/spmm.support), as under the JAX package's
shard_map.
"""

from __future__ import annotations

import torch

from ..parallel.comm import dp_psum
from .device import DeviceProblem
from .forward import _C_times, is_general
from .spmm import spmm_ell, support, tier2_offset


def diag_weights(dp: DeviceProblem, y_full: torch.Tensor) -> torch.Tensor:
    """d[i] = Σⱼ diag_w[i,j]·y[diag_cid[i,j]]; padding slots point at cid m
    with weight 0."""
    g = y_full[dp.diag_cid.reshape(-1)].reshape(dp.diag_cid.shape)
    return torch.sum(dp.diag_w * g, dim=1)


def apply_S_cx(dp: DeviceProblem, y_full: torch.Tensor, X: torch.Tensor,
               CX: torch.Tensor) -> torch.Tensor:
    """S @ X with CX = C@X precomputed."""
    out = y_full[dp.m] * CX + diag_weights(dp, y_full)[:, None] * X
    return _apply_lowrank(dp, y_full, X, out)


def assemble_s_tri(dp: DeviceProblem, y_full: torch.Tensor) -> torch.Tensor:
    """Values of S at the aggregate triu pattern -> (P_pad,):
    s_tri[p] = c_val_one[p]·y[m] + Σⱼ pos_val[p,j]·y[pos_cid[p,j]].
    Padding slots carry zero weights and are exactly zero; ELL padding
    entries point at the last (zero) slot (reference:
    src/coreop.jl:205-258)."""
    g = y_full[dp.pos_cid.reshape(-1)].reshape(dp.pos_cid.shape)
    return dp.c_val_one * y_full[dp.m] + torch.sum(dp.pos_val * g, dim=1)


def _external(dp) -> bool:
    return getattr(dp, "fn_apply_S", None) is not None


def s_tri_for(dp: DeviceProblem, y_full: torch.Tensor):
    """``assemble_s_tri`` where the general ``apply_S`` needs it, else
    None (the diagonal engines read S from C and the diagonal weights, an
    external model applies its own S)."""
    if _external(dp) or not is_general(dp):
        return None
    return assemble_s_tri(dp, y_full)


def _apply_lowrank(dp: DeviceProblem, y_full, X, out):
    for t in dp.lowrank:
        BtX = dp_psum(t.B.T @ X, dp)
        out = out + y_full[t.gid] * (t.B @ (t.d[:, None] * BtX))
    return out


def apply_S(dp: DeviceProblem, y_full: torch.Tensor, X: torch.Tensor,
            s_tri=None) -> torch.Tensor:
    """S @ X for X of shape (n_pad, r). On the general path S's values
    come from ``s_tri`` (assembled from y_full when not given) through
    one ELL SpMM."""
    if _external(dp):
        return dp.fn_apply_S(y_full, X)
    if not is_general(dp):
        return apply_S_cx(dp, y_full, X, _C_times(dp, X))
    return apply_S_general(dp, y_full, X, s_tri)


def apply_S_general(dp: DeviceProblem, y_full: torch.Tensor, X: torch.Tensor,
                    s_tri=None) -> torch.Tensor:
    """S @ X in the general engine's form, for any compiled problem: S's
    values at the aggregate pattern (``s_tri``, assembled from y_full
    when not given) through one ELL SpMM, plus the low-rank terms."""
    if s_tri is None:
        s_tri = assemble_s_tri(dp, y_full)
    Xs = support(dp, X)
    if dp.has_ell2:
        out = spmm_ell(Xs, dp.ell_cols, s_tri[dp.ell_tri], dp.ell2_rows,
                       dp.ell2_cols, s_tri[dp.ell2_tri], ids=dp.ell_ids,
                       offset=tier2_offset(dp))
    else:
        out = spmm_ell(Xs, dp.ell_cols, s_tri[dp.ell_tri],
                       ids=dp.ell_ids[:dp.ell_cols.numel()])
    return _apply_lowrank(dp, y_full, X, out)


def y_of(dp: DeviceProblem, lam, sigma, vio_raw) -> torch.Tensor:
    """y = [-min(λ_ub, λ - σ v); 1]."""
    y_head = -torch.minimum(dp.lam_ub, lam - sigma * vio_raw[: dp.m])
    return torch.cat([y_head, torch.ones(1, dtype=lam.dtype,
                                         device=lam.device)])


def gradient_cx(dp: DeviceProblem, R, CX, lam, sigma, vio_raw):
    """G = 2·S·R from the carried CX = C@R. Returns (G, y_full)."""
    y_full = y_of(dp, lam, sigma, vio_raw)
    return 2.0 * apply_S_cx(dp, y_full, R, CX), y_full


def gradient(dp: DeviceProblem, R, lam, sigma, vio_raw):
    """G = 2·S·R with y = [-min(λ_ub, λ - σ v); 1]. Returns (G, y_full)."""
    if _external(dp) or is_general(dp):
        y_full = y_of(dp, lam, sigma, vio_raw)
        return 2.0 * apply_S(dp, y_full, R), y_full
    return gradient_cx(dp, R, _C_times(dp, R), lam, sigma, vio_raw)
