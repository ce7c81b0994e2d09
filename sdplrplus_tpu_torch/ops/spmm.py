"""C_sparse @ X through the compiled two-tier ELL layout.

Counterpart of the JAX package's ``ops/spmm.py`` on one device: one row
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
``index_add``, as the JAX package leaves them to XLA. On one device the
row support is X itself and tier-2 target rows need no offset (the JAX
package's ``support`` and ``tier2_offset`` come with multi-device
solving).
"""

from __future__ import annotations

import torch

from .device import DeviceProblem
from .gather import gather_rows


def spmm_contract(val: torch.Tensor, Xg: torch.Tensor) -> torch.Tensor:
    """(n_loc, W) values × (n_loc, W, r) gathered rows -> (n_loc, r)."""
    return torch.einsum("nw,nwr->nr", val, Xg)


def spmm_ell(X: torch.Tensor, ell_cols: torch.Tensor, ell_val: torch.Tensor,
             ell2_rows=None, ell2_cols=None, ell2_val=None,
             ids=None) -> torch.Tensor:
    """out = M @ X for M in two-tier ELL layout (the JAX package's
    ``spmm_ell`` on one device). The rows of both tiers come from one
    gather at ``ids``, tier 1's column ids followed by tier 2's
    (``DeviceProblem.ell_ids``; concatenated here when not given)."""
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
        out = out.index_add(0, ell2_rows, contrib)
    return out


def spmm_C(dp: DeviceProblem, X: torch.Tensor) -> torch.Tensor:
    """C_sparse @ X (C's values aligned to the ELL slots; low-rank C terms
    are applied by the caller)."""
    if dp.has_ell2:
        return spmm_ell(X, dp.ell_cols, dp.cell_val, dp.ell2_rows,
                        dp.ell2_cols, dp.cell2_val, ids=dp.ell_ids)
    return spmm_ell(X, dp.ell_cols, dp.cell_val,
                    ids=dp.ell_ids[:dp.ell_cols.numel()])
