"""Line searches along a descent direction D for the augmented Lagrangian.

Counterpart of the JAX package's ``solver/linesearch.py``:
  * the exact quartic line search for equality-only problems
    (reference: src/linesearch.jl:4-127);
  * Armijo backtracking for inequality problems (reference:
    src/linesearch.jl:139-191): the sharp AL is piecewise quadratic in α,
    each candidate is evaluated in O(m) from the same two operator
    products, and α is halved up to 50 times.

Both commit the step algebraically, without re-evaluating 𝒜:
    vio_raw += α(α·A_DD + A_RD)   (reference: src/linesearch.jl:114-126)
"""

from __future__ import annotations

import torch

from ..ops.cubic import minimize_quartic
from ..ops.device import DeviceProblem
from ..ops.forward import A_linesearch


def exact_linesearch(dp: DeviceProblem, R, D, vio_raw, lam, sigma,
                     alpha_max=1.0):
    """Exact quartic line search (equality constraints only).
    Returns (alpha, L_at_alpha, new_vio_raw)."""
    A_RD, A_DD = A_linesearch(dp, R, D)
    return exact_from_products(dp, A_RD, A_DD, vio_raw, lam, sigma,
                               alpha_max)


def exact_from_products(dp: DeviceProblem, A_RD, A_DD, vio_raw, lam, sigma,
                        alpha_max=1.0):
    m = dp.m
    p0, p1, p2 = vio_raw[m], A_RD[m], A_DD[m]
    neg_q0, q1, q2 = vio_raw[:m], A_RD[:m], A_DD[:m]

    # quartic coefficients (reference: src/linesearch.jl:20-56)
    e = p0 - torch.dot(lam, neg_q0) + sigma * torch.dot(neg_q0, neg_q0) / 2.0
    d = p1 - torch.dot(lam, q1) + sigma * torch.dot(neg_q0, q1)
    c = (p2 - torch.dot(lam - sigma * neg_q0, q2)
         + sigma * torch.dot(q1, q1) / 2.0)
    b = sigma * torch.dot(q1, q2)
    a = sigma * torch.dot(q2, q2) / 2.0

    alpha, f_star = minimize_quartic((e, d, c, b, a), alpha_max)
    return alpha, f_star, vio_raw + alpha * (alpha * A_DD + A_RD)


ARMIJO_C = 1e-4
ARMIJO_MAX_HALVINGS = 50


def armijo_linesearch(dp: DeviceProblem, R, D, vio_raw, lam, sigma, y_full,
                      alpha_max=1.0):
    """Armijo backtracking for the sharp AL with inequalities. ``y_full``
    is the y of the preceding gradient (y[i] = -min(λ_ub, λ - σv)), used
    for the slope at 0 (reference: src/linesearch.jl:169-171).
    Returns (alpha, L_at_alpha, new_vio_raw)."""
    A_RD, A_DD = A_linesearch(dp, R, D)
    return armijo_from_products(dp, A_RD, A_DD, vio_raw, lam, sigma, y_full,
                                alpha_max)


def armijo_from_products(dp: DeviceProblem, A_RD, A_DD, vio_raw, lam, sigma,
                         y_full, alpha_max=1.0):
    """Armijo backtracking from precomputed operator products: the first
    of α_max, α_max/2, … (at most 50 halvings) with
    L(α) ≤ L(0) + c·α·slope, c = 1e-4, slope = A_RD[m] + y[:m]·A_RD[:m]."""
    m = dp.m

    def eval_AL(alpha):
        L = vio_raw[m] + alpha * A_RD[m] + alpha * alpha * A_DD[m]
        g = vio_raw[:m] + alpha * A_RD[:m] + alpha * alpha * A_DD[:m]
        lam_t = torch.minimum(dp.lam_ub, lam - sigma * g)
        return L + torch.sum(lam_t * lam_t - lam * lam) / (2.0 * sigma)

    L0 = eval_AL(torch.zeros_like(vio_raw[m]))
    slope = A_RD[m] + torch.dot(y_full[:m], A_RD[:m])
    alpha = torch.full_like(vio_raw[m], alpha_max)
    L_a = eval_AL(alpha)
    k = 0
    while k < ARMIJO_MAX_HALVINGS and bool(L_a > L0 + ARMIJO_C * alpha * slope):
        alpha = alpha / 2.0
        L_a = eval_AL(alpha)
        k += 1
    return alpha, L_a, vio_raw + alpha * (alpha * A_DD + A_RD)
