"""Adjoint operator 𝒜ᵀ on the dense and fast-diagonal engines:
S = Σᵢ yᵢAᵢ + y_m·C applied to a dense factor (the gradient G = 2·S·R
and the Lanczos matvec S·v).

Counterpart of the JAX package's ``ops/adjoint.py`` for problems whose
sparse-constraint entries all lie on the diagonal:
S@X = y_m·(C@X) + diag(w·y)⊙X + Σ_t y_t·B_t(d_t ⊙ B_tᵀX), with C@X a
matmul (dense engine) or one ELL SpMM (fast-diagonal engine). The
``*_cx`` forms take C@X precomputed (the inner loop's carried CX).
"""

from __future__ import annotations

import torch

from .device import DeviceProblem
from .forward import _C_times


def diag_weights(dp: DeviceProblem, y_full: torch.Tensor) -> torch.Tensor:
    """d[i] = Σⱼ diag_w[i,j]·y[diag_cid[i,j]]; padding slots point at cid m
    with weight 0."""
    g = y_full[dp.diag_cid.reshape(-1)].reshape(dp.diag_cid.shape)
    return torch.sum(dp.diag_w * g, dim=1)


def apply_S_cx(dp: DeviceProblem, y_full: torch.Tensor, X: torch.Tensor,
               CX: torch.Tensor) -> torch.Tensor:
    """S @ X with CX = C@X precomputed."""
    out = y_full[dp.m] * CX + diag_weights(dp, y_full)[:, None] * X
    for t in dp.lowrank:
        BtX = t.B.T @ X
        out = out + y_full[t.gid] * (t.B @ (t.d[:, None] * BtX))
    return out


def apply_S(dp: DeviceProblem, y_full: torch.Tensor,
            X: torch.Tensor) -> torch.Tensor:
    """S @ X for X of shape (n_pad, r)."""
    return apply_S_cx(dp, y_full, X, _C_times(dp, X))


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
    return gradient_cx(dp, R, _C_times(dp, R), lam, sigma, vio_raw)
