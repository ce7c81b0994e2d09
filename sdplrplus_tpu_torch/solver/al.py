"""Augmented-Lagrangian value and combined value+gradient.

Counterpart of the JAX package's ``solver/al.py`` (reference:
src/coreop.jl:11-31,319-349):

    ℒ(R, λ, σ) = ⟨C, RRᵀ⟩ + Σᵢ (λ̃ᵢ² - λᵢ²) / (2σ),   λ̃ᵢ = min(λ_ub, λᵢ - σvᵢ)

with v = 𝒜(RRᵀ) - b the raw violations.
"""

from __future__ import annotations

import torch

from ..ops.adjoint import gradient
from ..ops.device import DeviceProblem
from ..ops.forward import A_uu


def al_value(dp: DeviceProblem, R, lam, sigma):
    """Returns (L, vio_raw) where vio_raw is length m+1 with slot m = obj."""
    m = dp.m
    av = A_uu(dp, R)
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
    grad_norm = torch.sqrt(torch.sum(G * G))
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
