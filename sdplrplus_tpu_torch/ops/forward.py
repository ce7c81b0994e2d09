"""Forward constraint operator 𝒜: the constraint values ⟨Aᵢ, UUᵀ⟩ and
the objective ⟨C, UUᵀ⟩.

Counterpart of the JAX package's ``ops/forward.py``. Problems whose
sparse-constraint entries all lie on the diagonal take per-row dots
gathered through ``con_rows`` (wide diagonal constraints, such as
μ-conductance's volume constraint, through the dense ``wide_diag_w``
rows), and ⟨C, UVᵀ⟩ = ⟨U, CV⟩ needs one product with C:

  * dense engine (C held dense): a matmul C@V;
  * fast-diagonal engine (C sparse, ``C_dense`` is None): one ELL SpMM
    ``spmm_C``; the inner loop carries CX = C@R, so the ``*_cx`` forms
    take that product precomputed.

Problems with off-diagonal constraint entries outside entry mode (Lovász
θ past n_pad 8192, or with ``entry_mode=False``) take the general engine:
UUᵀ, (UVᵀ+VUᵀ)/2 or the line search's pair sampled at the aggregate
upper-triangular pattern by one row gather of the factor (or of [U|V],
[R|D]) at the pattern's rows and columns (``DeviceProblem.uv_ids``,
through the hand-written ``gather_rows`` on the card), then reduced per
constraint (``_reduce``), whose slot m is ⟨C, ·⟩. The entry-mask engine
builds its carries with the general ``A_uu`` too.

An external model (``adapter.CustomModel``) supplies its own ``fn_A_uu``
and ``fn_A_uv``; ``A_uu``, ``A_uv`` and ``A_linesearch`` dispatch to them
first.

Low-rank operands are tall-skinny matmuls UᵀB. Output convention: a
length-(m+1) vector whose slot ``m`` carries ⟨C, ·⟩ (the objective) and
slots 0..m-1 carry ⟨Aᵢ, ·⟩.

On a rank-local problem (``dp.spmd`` set) U and V are this rank's row
blocks: row dots and objective partials are summed across ranks
(``_psum``), the per-row diagonal samples are all-gathered before the
replicated constraint lookups, the dense C's local rows multiply the
all-gathered factor (``_full``), and the general engine samples its
block of the pattern from the all-gathered factor, as the JAX package's
``ops/forward.py`` does under shard_map.
"""

from __future__ import annotations

import torch

from ..parallel.comm import dp_full as _full
from ..parallel.comm import dp_psum as _psum
from .device import DeviceProblem
from .gather import gather_rows
from .spmm import spmm_C


def is_general(dp: DeviceProblem) -> bool:
    """Off-diagonal constraint entries with C not held dense: the
    constraint values come from the aggregate pattern (``_reduce``)."""
    return dp.C_dense is None and not dp.all_cons_diagonal


def _C_times(dp: DeviceProblem, X: torch.Tensor) -> torch.Tensor:
    """C@X on the diagonal engines (sparse part of C; low-rank C terms are
    added by the caller). The general engine reads ⟨C, ·⟩ from the
    objective slot of ``_reduce`` and S·X from the general ``apply_S``."""
    return dp.C_dense @ _full(dp, X) if dp.C_dense is not None \
        else spmm_C(dp, X)


def _reduce(dp: DeviceProblem, uv: torch.Tensor) -> torch.Tensor:
    """uv values at the aggregate pattern (P_pad,) -> (m+1,) constraint
    values, slot m the objective ⟨C, ·⟩ (wide constraints through their
    dense P-aligned rows ``wide_val_two``). On a rank-local problem uv
    is this rank's pattern block: the objective and wide partials are
    summed, and uv is all-gathered for the replicated lookups."""
    obj = _psum(torch.dot(dp.c_val_two, uv), dp)
    if dp.wide_gids:
        wide = _psum(dp.wide_val_two @ uv, dp)
    uv = _full(dp, uv)
    g = uv[dp.con_pos.reshape(-1)]
    cons = torch.sum(dp.con_val_two * g.reshape(dp.m, dp.con_width), dim=1)
    if dp.wide_gids:
        cons = cons.index_copy(
            0, torch.tensor(dp.wide_gids, device=cons.device), wide)
    return torch.cat([cons, obj[None]])


def uv_values_uu(dp: DeviceProblem, U: torch.Tensor) -> torch.Tensor:
    """(UUᵀ) sampled at the aggregate triu pattern -> (P_pad,): one row
    gather of U at the pattern's rows, then its columns
    (``DeviceProblem.uv_ids``; on a rank-local problem this rank's
    block of the pattern, from the all-gathered U)."""
    Ug = gather_rows(_full(dp, U).contiguous(), dp.uv_ids)
    p = dp.uv_ids.shape[0] // 2
    return torch.sum(Ug[:p] * Ug[p:], dim=1)


def _gather_pair(dp: DeviceProblem, U: torch.Tensor, V: torch.Tensor):
    """[U|V] at the pattern's rows and at its columns, by one row gather
    at width 2r: (Ur, Vr, Uc, Vc), each (P_pad, r)."""
    r = U.shape[1]
    G = gather_rows(_full(dp, torch.cat([U, V], dim=1)), dp.uv_ids)
    p = dp.uv_ids.shape[0] // 2
    Gr, Gc = G[:p], G[p:]
    return Gr[:, :r], Gr[:, r:], Gc[:, :r], Gc[:, r:]


def uv_values_uv(dp: DeviceProblem, U: torch.Tensor,
                 V: torch.Tensor) -> torch.Tensor:
    """((UVᵀ+VUᵀ)/2) sampled at the aggregate triu pattern -> (P_pad,)."""
    Ur, Vr, Uc, Vc = _gather_pair(dp, U, V)
    return 0.5 * (torch.sum(Ur * Vc, dim=1) + torch.sum(Vr * Uc, dim=1))


def _dense_cons(dp: DeviceProblem, rowvals: torch.Tensor) -> torch.Tensor:
    """cons_k = Σⱼ con_val_two[k,j] · rowvals[con_rows[k,j]] (rowvals
    all-gathered first on a rank-local problem)."""
    g = _full(dp, rowvals)[dp.con_rows.reshape(-1)]
    return torch.sum(dp.con_val_two * g.reshape(dp.m, dp.con_width), dim=1)


def cons_from_rowvals(dp: DeviceProblem, rowvals: torch.Tensor) -> torch.Tensor:
    """(m,) constraint values of an all-diagonal problem from the per-row
    diagonal samples rowvals[i] = (UVᵀ)_ii: narrow constraints through
    ``con_rows``, wide ones through the ``wide_diag_w`` matvec."""
    cons = _dense_cons(dp, rowvals)
    if dp.wide_gids:
        cons = cons.index_copy(
            0, torch.tensor(dp.wide_gids, device=cons.device),
            _psum(dp.wide_diag_w @ rowvals, dp))
    return cons


def _fast_vals(dp: DeviceProblem, rowvals, obj) -> torch.Tensor:
    return torch.cat([cons_from_rowvals(dp, rowvals), obj[None]])


def _add_lowrank(vals, dp, U, V, scale=1.0):
    for t in dp.lowrank:
        UtB = _psum(U.T @ t.B, dp)
        VtB = UtB if V is U else _psum(V.T @ t.B, dp)
        vals = vals.index_add(
            0, torch.tensor([t.gid], device=vals.device),
            (scale * torch.sum(t.d * torch.sum(UtB * VtB, dim=0))).reshape(1),
        )
    return vals


def A_uu_cx(dp: DeviceProblem, U: torch.Tensor, CX: torch.Tensor):
    """𝒜(UUᵀ) with CX = C@U precomputed: the objective is ⟨U, CX⟩,
    the constraints reduce over row dots."""
    vals = _fast_vals(dp, torch.sum(U * U, dim=1),
                      _psum(torch.sum(U * CX), dp))
    return _add_lowrank(vals, dp, U, U)


def A_linesearch_cd(dp: DeviceProblem, R: torch.Tensor, D: torch.Tensor,
                    CD: torch.Tensor):
    """(A_RD, A_DD) from the iteration's one product CD = C@D:
    A_RD = 𝒜(RDᵀ + DRᵀ) (objective slot 2⟨R, CD⟩) and A_DD = 𝒜(DDᵀ)
    (objective slot ⟨D, CD⟩)."""
    A_RD = _fast_vals(dp, 2.0 * torch.sum(R * D, dim=1),
                      2.0 * _psum(torch.sum(R * CD), dp))
    A_DD = _fast_vals(dp, torch.sum(D * D, dim=1),
                      _psum(torch.sum(D * CD), dp))
    return _add_lowrank(A_RD, dp, R, D, 2.0), _add_lowrank(A_DD, dp, D, D)


def A_uu(dp: DeviceProblem, U: torch.Tensor) -> torch.Tensor:
    """𝒜(UUᵀ) -> (m+1,), slot m = ⟨C, UUᵀ⟩ (= ⟨U, CU⟩ when every
    constraint entry is diagonal)."""
    if getattr(dp, "fn_A_uu", None) is not None:  # external model
        return dp.fn_A_uu(U)
    if is_general(dp):
        return _add_lowrank(_reduce(dp, uv_values_uu(dp, U)), dp, U, U)
    return A_uu_cx(dp, U, _C_times(dp, U))


def A_uv(dp: DeviceProblem, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """𝒜((UVᵀ+VUᵀ)/2) -> (m+1,); ⟨C,(UVᵀ+VUᵀ)/2⟩ = ⟨U, CV⟩ (C symmetric)
    on the diagonal engines."""
    if getattr(dp, "fn_A_uv", None) is not None:  # external model
        return dp.fn_A_uv(U, V)
    if is_general(dp):
        return _add_lowrank(_reduce(dp, uv_values_uv(dp, U, V)), dp, U, V)
    vals = _fast_vals(dp, torch.sum(U * V, dim=1),
                      _psum(torch.sum(U * _C_times(dp, V)), dp))
    return _add_lowrank(vals, dp, U, V)


def A_linesearch(dp: DeviceProblem, R: torch.Tensor, D: torch.Tensor):
    """(A_RD, A_DD) with A_RD = 𝒜(RDᵀ + DRᵀ) (the ×2-scaled quantity the
    line search uses) and A_DD = 𝒜(DDᵀ). On the diagonal engines ONE
    product CD serves both objective slots: 2⟨R, CD⟩ and ⟨D, CD⟩; on the
    general engine one gather of [R|D] at width 2r serves both samples."""
    if getattr(dp, "fn_A_uv", None) is not None:  # external model
        return 2.0 * dp.fn_A_uv(R, D), dp.fn_A_uu(D)
    if is_general(dp):
        Rr, Dr, Rc, Dc = _gather_pair(dp, R, D)
        A_RD = _reduce(dp, torch.sum(Rr * Dc + Dr * Rc, dim=1))
        A_DD = _reduce(dp, torch.sum(Dr * Dc, dim=1))
        return _add_lowrank(A_RD, dp, R, D, 2.0), _add_lowrank(A_DD, dp, D, D)
    return A_linesearch_cd(dp, R, D, _C_times(dp, D))
