"""C_sparse @ X through the compiled two-tier ELL layout.

Counterpart of the JAX package's ``ops/spmm.py`` on one device: one row
gather of X at the ELL column ids, a contraction over the ELL width, and
the tier-2 rows index-added into their target rows. The fast-diagonal
engine calls it once per inner iteration (CD = C@D) and at every re-sync,
every Lanczos pass once (the S-matvec); the dense engine once per strict
boundary (the projected feasible objective and the least-squares dual
multiplier), exactly where the JAX package does.

The row gather is the hand-written CUDA kernel ``ops/gather.gather_rows``
on the card (tier 1 and tier 2 each launch it once per SpMM) and its
plain version ``X[idx]`` on the CPU. The contraction stays a
``torch.einsum``, as the JAX package leaves it to XLA. On one device the
row support is X itself and tier-2 target rows need no offset (the JAX
package's ``support`` and ``tier2_offset`` come with multi-device
solving).
"""

from __future__ import annotations

import torch

from .device import DeviceProblem
from .gather import gather_rows


def spmm_gather(X: torch.Tensor, ell_cols: torch.Tensor) -> torch.Tensor:
    """(n_loc, W) column ids -> (n_loc, W, r) rows of X."""
    n_loc, W = ell_cols.shape
    return gather_rows(X.contiguous(), ell_cols.reshape(-1)).reshape(
        n_loc, W, X.shape[1])


def spmm_contract(val: torch.Tensor, Xg: torch.Tensor) -> torch.Tensor:
    """(n_loc, W) values × (n_loc, W, r) gathered rows -> (n_loc, r)."""
    return torch.einsum("nw,nwr->nr", val, Xg)


def spmm_tier2(out, X, ell2_rows, ell2_cols, ell2_val):
    """Add the tier-2 rows (degree beyond the tier-1 width) into ``out``."""
    contrib = spmm_contract(ell2_val, spmm_gather(X, ell2_cols))
    return out.index_add(0, ell2_rows, contrib)


def spmm_ell(X: torch.Tensor, ell_cols: torch.Tensor, ell_val: torch.Tensor,
             ell2_rows=None, ell2_cols=None, ell2_val=None) -> torch.Tensor:
    """out = M @ X for M in two-tier ELL layout (the JAX package's
    ``spmm_ell`` on one device)."""
    out = spmm_contract(ell_val, spmm_gather(X, ell_cols))
    if ell2_rows is not None and ell2_rows.shape[0] > 0:
        out = spmm_tier2(out, X, ell2_rows, ell2_cols, ell2_val)
    return out


def spmm_C(dp: DeviceProblem, X: torch.Tensor) -> torch.Tensor:
    """C_sparse @ X (C's values aligned to the ELL slots; low-rank C terms
    are applied by the caller)."""
    if dp.has_ell2:
        return spmm_ell(X, dp.ell_cols, dp.cell_val, dp.ell2_rows,
                        dp.ell2_cols, dp.cell2_val)
    return spmm_ell(X, dp.ell_cols, dp.cell_val)
