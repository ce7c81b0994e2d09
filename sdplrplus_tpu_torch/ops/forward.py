"""Forward constraint operator 𝒜 on the dense engine.

Counterpart of the JAX package's ``ops/forward.py`` for dense-C problems
(every sparse constraint entry diagonal, C held dense): ⟨C, UVᵀ⟩ is one
matmul C@V and a dot, and the constraint values are per-row dots
gathered through ``con_rows``. Low-rank operands are tall-skinny
matmuls UᵀB. The gather engines (fast-diagonal ELL, general) are later
slices of the port.

Output convention: a length-(m+1) vector whose slot ``m`` carries
⟨C, ·⟩ (the objective) and slots 0..m-1 carry ⟨Aᵢ, ·⟩.
"""

from __future__ import annotations

import torch

from .device import DeviceProblem


def _require_dense(dp: DeviceProblem):
    if dp.C_dense is None:
        raise NotImplementedError(
            "only the dense-C engine is ported; the fast-diagonal ELL and "
            "general gather engines are ROADMAP slices B and E"
        )


def _dense_cons(dp: DeviceProblem, rowvals: torch.Tensor) -> torch.Tensor:
    """cons_k = Σⱼ con_val_two[k,j] · rowvals[con_rows[k,j]]."""
    g = rowvals[dp.con_rows.reshape(-1)]
    return torch.sum(dp.con_val_two * g.reshape(dp.m, dp.con_width), dim=1)


def _add_lowrank(vals, dp, U, V, scale=1.0):
    for t in dp.lowrank:
        UtB = U.T @ t.B
        VtB = UtB if V is U else V.T @ t.B
        vals = vals.index_add(
            0, torch.tensor([t.gid], device=vals.device),
            (scale * torch.sum(t.d * torch.sum(UtB * VtB, dim=0))).reshape(1),
        )
    return vals


def A_uu(dp: DeviceProblem, U: torch.Tensor) -> torch.Tensor:
    """𝒜(UUᵀ) -> (m+1,), slot m = ⟨C, UUᵀ⟩ = ⟨U, CU⟩."""
    _require_dense(dp)
    obj = torch.sum(U * (dp.C_dense @ U))
    vals = torch.cat([_dense_cons(dp, torch.sum(U * U, dim=1)), obj[None]])
    return _add_lowrank(vals, dp, U, U)


def A_uv(dp: DeviceProblem, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """𝒜((UVᵀ+VUᵀ)/2) -> (m+1,); ⟨C,(UVᵀ+VUᵀ)/2⟩ = ⟨U, CV⟩ (C symmetric)."""
    _require_dense(dp)
    obj = torch.sum(U * (dp.C_dense @ V))
    vals = torch.cat([_dense_cons(dp, torch.sum(U * V, dim=1)), obj[None]])
    return _add_lowrank(vals, dp, U, V)


def A_linesearch(dp: DeviceProblem, R: torch.Tensor, D: torch.Tensor):
    """(A_RD, A_DD) with A_RD = 𝒜(RDᵀ + DRᵀ) (the ×2-scaled quantity the
    line search uses) and A_DD = 𝒜(DDᵀ); ONE matmul CD serves both
    objective slots: 2⟨R, CD⟩ and ⟨D, CD⟩."""
    _require_dense(dp)
    CD = dp.C_dense @ D
    obj_RD = 2.0 * torch.sum(R * CD)
    obj_DD = torch.sum(D * CD)
    A_RD = torch.cat([_dense_cons(dp, 2.0 * torch.sum(R * D, dim=1)),
                      obj_RD[None]])
    A_DD = torch.cat([_dense_cons(dp, torch.sum(D * D, dim=1)), obj_DD[None]])
    A_RD = _add_lowrank(A_RD, dp, R, D, 2.0)
    A_DD = _add_lowrank(A_DD, dp, D, D)
    return A_RD, A_DD
