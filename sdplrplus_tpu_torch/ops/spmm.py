"""C_sparse @ X through the compiled two-tier ELL layout.

Counterpart of the JAX package's ``ops/spmm.py::spmm_C`` on one device:
one row gather ``X[ell_cols]``, a contraction over the ELL width, and the
tier-2 rows index-added into their target rows. The fast-diagonal engine
calls it once per inner iteration (CD = C@D) and at every re-sync; the
dense engine once per strict boundary (the projected feasible objective
and the least-squares dual multiplier), exactly where the JAX package
does.
"""

from __future__ import annotations

import torch

from .device import DeviceProblem


def spmm_gather(X: torch.Tensor, ell_cols: torch.Tensor) -> torch.Tensor:
    """(n_loc, W) column ids -> (n_loc, W, r) rows of X."""
    n_loc, W = ell_cols.shape
    return X[ell_cols.reshape(-1)].reshape(n_loc, W, X.shape[1])


def spmm_contract(val: torch.Tensor, Xg: torch.Tensor) -> torch.Tensor:
    """(n_loc, W) values × (n_loc, W, r) gathered rows -> (n_loc, r)."""
    return torch.einsum("nw,nwr->nr", val, Xg)


def spmm_tier2(out, X, ell2_rows, ell2_cols, ell2_val):
    """Add the tier-2 rows (degree beyond the tier-1 width) into ``out``."""
    contrib = spmm_contract(ell2_val, spmm_gather(X, ell2_cols))
    return out.index_add(0, ell2_rows, contrib)


def spmm_C(dp: DeviceProblem, X: torch.Tensor) -> torch.Tensor:
    """C_sparse @ X (C's values aligned to the ELL slots; low-rank C terms
    are applied by the caller)."""
    out = spmm_contract(dp.cell_val, spmm_gather(X, dp.ell_cols))
    if dp.has_ell2:
        out = spmm_tier2(out, X, dp.ell2_rows, dp.ell2_cols, dp.cell2_val)
    return out
