"""C_sparse @ X through the compiled two-tier ELL layout.

Counterpart of the JAX package's ``ops/spmm.py``: one row
gather of X at the ELL column ids, a contraction over the ELL width, and
the tier-2 rows index-added into their target rows. The fast-diagonal
engine calls it once per inner iteration (CD = C@D) and at every re-sync,
every Lanczos pass once (the S-matvec); the dense engine once per strict
boundary (the projected feasible objective and the least-squares dual
multiplier), exactly where the JAX package does.

The row gather is the hand-written CUDA kernel ``ops/gather.gather_rows``
on the card and its plain version ``X[idx]`` on the CPU: one launch per
SpMM, over tier 1's column ids followed by tier 2's (``dp.ell_ids``,
built once with the problem), whose output is cut into the two tiers'
views. The contractions stay ``torch.einsum``s and the tier-2 rows an
``index_add``, as the JAX package leaves them to XLA.

The rows the column ids address are the row support (``support``): X
itself on one device; on a rank-local problem the all-gathered factor,
or, where the compile's volume rule picks the halo layout,
[X_local; halo], whose nd − 1 blocks of H rows come from the other
ranks by ring shifts (the compile remapped the local column ids to that
layout). Tier-2 target rows are global and are localized by this rank's
row offset (``tier2_offset``).
"""

from __future__ import annotations

import torch

from ..parallel.comm import dp_full, mesh_of, ring_shift, row_offset
from .device import DeviceProblem
from .gather import gather_rows


def support(dp: DeviceProblem, X: torch.Tensor) -> torch.Tensor:
    """The rows the ELL column ids of ``dp`` address: X on one device,
    the all-gathered factor on a rank-local problem, or [X_local; halo]
    when ``dp.halo_send`` is set: block t − 1 of the halo is what rank
    − t sent, the rows its list ``halo_send[t − 1]`` names (JAX package:
    ops/spmm.py:44-68)."""
    mesh = mesh_of(dp)
    if mesh is None or dp.halo_send is None:
        return dp_full(dp, X)
    bufs = [X]
    for t in range(1, mesh.size):
        bufs.append(ring_shift(X.index_select(0, dp.halo_send[t - 1]), t,
                               mesh))
    return torch.cat(bufs)


def tier2_offset(dp: DeviceProblem) -> int:
    """Offset localizing tier-2 target rows: this rank's first row (0 on
    one device)."""
    return row_offset(dp)


def spmm_contract(val: torch.Tensor, Xg: torch.Tensor) -> torch.Tensor:
    """(n_loc, W) values × (n_loc, W, r) gathered rows -> (n_loc, r)."""
    return torch.einsum("nw,nwr->nr", val, Xg)


def spmm_ell(X: torch.Tensor, ell_cols: torch.Tensor, ell_val: torch.Tensor,
             ell2_rows=None, ell2_cols=None, ell2_val=None,
             ids=None, offset: int = 0) -> torch.Tensor:
    """out = M @ X for M in two-tier ELL layout (the JAX package's
    ``spmm_ell``). X is the row support the column ids address. The rows
    of both tiers come from one gather at ``ids``, tier 1's column ids
    followed by tier 2's (``DeviceProblem.ell_ids``; concatenated here
    when not given); tier-2 rows land at ``ell2_rows − offset``."""
    tier2 = ell2_rows is not None and ell2_rows.shape[0] > 0
    if ids is None:
        ids = torch.cat([ell_cols.reshape(-1), ell2_cols.reshape(-1)]) \
            if tier2 else ell_cols.reshape(-1)
    r = X.shape[1]
    Xg = gather_rows(X.contiguous(), ids)
    n1 = ell_cols.numel()
    out = spmm_contract(ell_val, Xg[:n1].view(*ell_cols.shape, r))
    if tier2:
        contrib = spmm_contract(ell2_val, Xg[n1:].view(*ell2_cols.shape, r))
        out = out.index_add(0, ell2_rows - offset if offset else ell2_rows,
                            contrib)
    return out


def spmm_C(dp: DeviceProblem, X: torch.Tensor) -> torch.Tensor:
    """C_sparse @ X (C's values aligned to the ELL slots; low-rank C terms
    are applied by the caller). X is this rank's rows; the result's rows
    are those of ``dp.ell_cols``."""
    Xs = support(dp, X)
    if dp.has_ell2:
        return spmm_ell(Xs, dp.ell_cols, dp.cell_val, dp.ell2_rows,
                        dp.ell2_cols, dp.cell2_val, ids=dp.ell_ids,
                        offset=tier2_offset(dp))
    return spmm_ell(Xs, dp.ell_cols, dp.cell_val,
                    ids=dp.ell_ids[:dp.ell_cols.numel()])
