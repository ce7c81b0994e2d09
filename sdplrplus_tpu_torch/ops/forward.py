"""Forward constraint operator 𝒜 on the dense and fast-diagonal engines.

Counterpart of the JAX package's ``ops/forward.py`` for problems whose
sparse-constraint entries all lie on the diagonal. The constraint values
are then per-row dots gathered through ``con_rows`` (wide diagonal
constraints, such as μ-conductance's volume constraint, through the
dense ``wide_diag_w`` rows), and ⟨C, UVᵀ⟩ = ⟨U, CV⟩ needs one product
with C:

  * dense engine (C held dense): a matmul C@V;
  * fast-diagonal engine (C sparse, ``C_dense`` is None): one ELL SpMM
    ``spmm_C``; the inner loop carries CX = C@R, so the ``*_cx`` forms
    take that product precomputed.

Low-rank operands are tall-skinny matmuls UᵀB. Problems with off-diagonal
constraint entries need the general gather engine (a later slice).

Output convention: a length-(m+1) vector whose slot ``m`` carries
⟨C, ·⟩ (the objective) and slots 0..m-1 carry ⟨Aᵢ, ·⟩.
"""

from __future__ import annotations

import torch

from .device import DeviceProblem
from .spmm import spmm_C


def _require_diagonal(dp: DeviceProblem):
    if dp.C_dense is None and not dp.all_cons_diagonal:
        raise NotImplementedError(
            "constraints with off-diagonal entries need the general gather "
            "engine, which is not ported yet (ROADMAP slice E)"
        )


def _C_times(dp: DeviceProblem, X: torch.Tensor) -> torch.Tensor:
    """C@X (sparse part of C; low-rank C terms are added by the caller)."""
    _require_diagonal(dp)
    return dp.C_dense @ X if dp.C_dense is not None else spmm_C(dp, X)


def _dense_cons(dp: DeviceProblem, rowvals: torch.Tensor) -> torch.Tensor:
    """cons_k = Σⱼ con_val_two[k,j] · rowvals[con_rows[k,j]]."""
    g = rowvals[dp.con_rows.reshape(-1)]
    return torch.sum(dp.con_val_two * g.reshape(dp.m, dp.con_width), dim=1)


def cons_from_rowvals(dp: DeviceProblem, rowvals: torch.Tensor) -> torch.Tensor:
    """(m,) constraint values of an all-diagonal problem from the per-row
    diagonal samples rowvals[i] = (UVᵀ)_ii: narrow constraints through
    ``con_rows``, wide ones through the ``wide_diag_w`` matvec."""
    cons = _dense_cons(dp, rowvals)
    if dp.wide_gids:
        cons = cons.index_copy(
            0, torch.tensor(dp.wide_gids, device=cons.device),
            dp.wide_diag_w @ rowvals)
    return cons


def _fast_vals(dp: DeviceProblem, rowvals, obj) -> torch.Tensor:
    return torch.cat([cons_from_rowvals(dp, rowvals), obj[None]])


def _add_lowrank(vals, dp, U, V, scale=1.0):
    for t in dp.lowrank:
        UtB = U.T @ t.B
        VtB = UtB if V is U else V.T @ t.B
        vals = vals.index_add(
            0, torch.tensor([t.gid], device=vals.device),
            (scale * torch.sum(t.d * torch.sum(UtB * VtB, dim=0))).reshape(1),
        )
    return vals


def A_uu_cx(dp: DeviceProblem, U: torch.Tensor, CX: torch.Tensor):
    """𝒜(UUᵀ) with CX = C@U precomputed: the objective is ⟨U, CX⟩,
    the constraints reduce over row dots."""
    vals = _fast_vals(dp, torch.sum(U * U, dim=1), torch.sum(U * CX))
    return _add_lowrank(vals, dp, U, U)


def A_linesearch_cd(dp: DeviceProblem, R: torch.Tensor, D: torch.Tensor,
                    CD: torch.Tensor):
    """(A_RD, A_DD) from the iteration's one product CD = C@D:
    A_RD = 𝒜(RDᵀ + DRᵀ) (objective slot 2⟨R, CD⟩) and A_DD = 𝒜(DDᵀ)
    (objective slot ⟨D, CD⟩)."""
    A_RD = _fast_vals(dp, 2.0 * torch.sum(R * D, dim=1),
                      2.0 * torch.sum(R * CD))
    A_DD = _fast_vals(dp, torch.sum(D * D, dim=1), torch.sum(D * CD))
    return _add_lowrank(A_RD, dp, R, D, 2.0), _add_lowrank(A_DD, dp, D, D)


def A_uu(dp: DeviceProblem, U: torch.Tensor) -> torch.Tensor:
    """𝒜(UUᵀ) -> (m+1,), slot m = ⟨C, UUᵀ⟩ = ⟨U, CU⟩."""
    return A_uu_cx(dp, U, _C_times(dp, U))


def A_uv(dp: DeviceProblem, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """𝒜((UVᵀ+VUᵀ)/2) -> (m+1,); ⟨C,(UVᵀ+VUᵀ)/2⟩ = ⟨U, CV⟩ (C symmetric)."""
    vals = _fast_vals(dp, torch.sum(U * V, dim=1),
                      torch.sum(U * _C_times(dp, V)))
    return _add_lowrank(vals, dp, U, V)


def A_linesearch(dp: DeviceProblem, R: torch.Tensor, D: torch.Tensor):
    """(A_RD, A_DD) with A_RD = 𝒜(RDᵀ + DRᵀ) (the ×2-scaled quantity the
    line search uses) and A_DD = 𝒜(DDᵀ); ONE product CD serves both
    objective slots: 2⟨R, CD⟩ and ⟨D, CD⟩."""
    return A_linesearch_cd(dp, R, D, _C_times(dp, D))
