"""Randomized rounding callbacks for benchmark quality metrics.

Counterpart of the JAX package's ``utils/rounding.py``, the equivalent
of the reference's rounding procedures (reference: exps/test.jl:71-106):
100 random-hyperplane cuts for MaxCut and sorted balanced rounding for
MinimumBisection. Here all ``n_cuts`` hyperplanes are taken at once in
torch, on the device the caller names (the card unless ``device="cpu"``):
Z = sign(R·G) for G of shape (r, n_cuts), and every cut value
0.25·zᵀLz as one column sum of Z ⊙ (L Z), with L the graph Laplacian as a
float64 sparse CSR tensor. The hyperplanes are drawn on the host from
``np.random.default_rng(seed)``, the stream of the JAX package's per-cut
``rng.normal(size=r)`` draws, so both packages cut along the same
hyperplanes. The cut values are sums of the Laplacian's entries, exact
in float64 for integer weights, so the result does not depend on the
device's summation order.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..config import require_device


def eval_cut(L: sp.spmatrix, x: np.ndarray) -> float:
    """0.25 · xᵀ L x (reference: exps/test.jl:72-75)."""
    return float(0.25 * x @ (L @ x))


def _laplacian(A: sp.spmatrix) -> sp.csr_matrix:
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    return (sp.diags(d) - A).tocsr()


def _projections(A: sp.spmatrix, R, n_cuts: int, seed: int, device):
    """(L as a float64 CSR tensor, R·G (n, n_cuts) in float64) on
    ``device``; G's columns are the hyperplanes' normals."""
    dev = require_device(device, "the rounding's device")
    L = _laplacian(A)
    L_t = torch.sparse_csr_tensor(
        torch.as_tensor(L.indptr, dtype=torch.int64),
        torch.as_tensor(L.indices, dtype=torch.int64),
        torch.as_tensor(L.data, dtype=torch.float64),
        size=L.shape, check_invariants=True).to(dev)
    R_t = torch.as_tensor(np.asarray(R, dtype=np.float64)).to(dev)
    G = np.random.default_rng(seed).normal(size=(n_cuts, R_t.shape[1]))
    return L_t, R_t @ torch.as_tensor(G.T.copy()).to(dev)


def _cut_values(L_t, Z) -> torch.Tensor:
    """0.25·zᵀLz for every column z of Z."""
    return 0.25 * torch.sum(Z * (L_t @ Z), dim=0)


def maxcut_rounding(A: sp.spmatrix, R, n_cuts: int = 100, seed: int = 0,
                    device="cuda") -> float:
    """Best of ``n_cuts`` random hyperplane cuts
    (reference: exps/test.jl:77-87). R is the n×r factor."""
    L_t, P = _projections(A, R, n_cuts, seed, device)
    Z = torch.sign(P)
    Z[Z == 0] = 1.0
    return float(torch.max(_cut_values(L_t, Z)))


def minimum_bisection_rounding(A: sp.spmatrix, R, n_cuts: int = 100,
                               seed: int = 0, device="cuda") -> float:
    """Best of ``n_cuts`` sorted balanced roundings
    (reference: exps/test.jl:89-106): along each hyperplane's normal the
    lower ⌊n/2⌋ vertices get +1, the rest −1."""
    L_t, P = _projections(A, R, n_cuts, seed, device)
    n = P.shape[0]
    perm = torch.argsort(P, dim=0, stable=True)
    half = torch.where(torch.arange(1, n + 1, device=P.device) * 2 <= n,
                       1.0, -1.0).to(torch.float64)
    Z = torch.empty_like(P).scatter_(0, perm, half[:, None].expand_as(P))
    return float(torch.min(_cut_values(L_t, Z)))


def dummy_callback(A, R) -> float:
    return 0.0
