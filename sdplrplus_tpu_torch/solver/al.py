"""Augmented-Lagrangian value and combined value+gradient.

Counterpart of the JAX package's ``solver/al.py`` (reference:
src/coreop.jl:11-31,319-349):

    ℒ(R, λ, σ) = ⟨C, RRᵀ⟩ + Σᵢ (λ̃ᵢ² - λᵢ²) / (2σ),   λ̃ᵢ = min(λ_ub, λᵢ - σvᵢ)

with v = 𝒜(RRᵀ) - b the raw violations.
"""

from __future__ import annotations

import torch

from ..ops.adjoint import gradient, gradient_cx
from ..parallel.comm import dp_psum
from ..ops.device import DeviceProblem
from ..ops.forward import A_uu, A_uu_cx
from ..ops.spmm import spmm_C


def al_value(dp: DeviceProblem, R, lam, sigma):
    """Returns (L, vio_raw) where vio_raw is length m+1 with slot m = obj."""
    return _al_from_values(dp, A_uu(dp, R), lam, sigma)


def _al_from_values(dp: DeviceProblem, av, lam, sigma):
    m = dp.m
    obj = av[m]
    v = av[:m] - dp.b
    lam_t = torch.minimum(dp.lam_ub, lam - sigma * v)
    L = obj + torch.sum(lam_t * lam_t - lam * lam) / (2.0 * sigma)
    return L, torch.cat([v, obj[None]])


def capped_vio(dp: DeviceProblem, vio_raw):
    """primal_vio[i] = max(raw, lb): equality keeps both signs, inequality
    caps at 0 (reference: src/coreop.jl:22,340-342)."""
    return torch.maximum(vio_raw[: dp.m], dp.vio_lb)


def norms(dp: DeviceProblem, G, vio_raw, gtol_relative: bool,
          ptol_relative: bool):
    grad_norm = torch.sqrt(dp_psum(torch.sum(G * G), dp))
    if gtol_relative:
        grad_norm = grad_norm / dp.normC
    vio_norm = torch.linalg.norm(capped_vio(dp, vio_raw))
    if ptol_relative:
        vio_norm = vio_norm / dp.normb
    return grad_norm, vio_norm


def al_value_grad(dp: DeviceProblem, R, lam, sigma,
                  gtol_relative: bool, ptol_relative: bool):
    """fg! (reference: src/coreop.jl:323-349).

    Returns (L, vio_raw, G, y_full, grad_norm, vio_norm)."""
    L, vio_raw = al_value(dp, R, lam, sigma)
    G, y_full = gradient(dp, R, lam, sigma, vio_raw)
    grad_norm, vio_norm = norms(dp, G, vio_raw, gtol_relative, ptol_relative)
    return L, vio_raw, G, y_full, grad_norm, vio_norm


def al_value_grad_cx(dp: DeviceProblem, R, lam, sigma,
                     gtol_relative: bool, ptol_relative: bool):
    """fg! on the fast-diagonal engine: ONE SpMM (CX = C_sparse @ R) serves
    the objective, the constraints and the gradient.

    Returns (L, vio_raw, G, y_full, grad_norm, vio_norm, CX); CX seeds the
    carried recurrence of the inner loop (solver/inner.py)."""
    CX = spmm_C(dp, R)
    L, vio_raw = _al_from_values(dp, A_uu_cx(dp, R, CX), lam, sigma)
    G, y_full = gradient_cx(dp, R, CX, lam, sigma, vio_raw)
    grad_norm, vio_norm = norms(dp, G, vio_raw, gtol_relative, ptol_relative)
    return L, vio_raw, G, y_full, grad_norm, vio_norm, CX
