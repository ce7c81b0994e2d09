"""Line searches along a descent direction D for the augmented Lagrangian.

Counterpart of the JAX package's ``solver/linesearch.py``. The exact
quartic line search (reference: src/linesearch.jl:4-127) is ported; the
Armijo backtracking for inequality problems is ROADMAP slice C.

The step is committed algebraically, without re-evaluating 𝒜:
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


def armijo_linesearch(*args, **kwargs):
    raise NotImplementedError(
        "the Armijo line search (inequality families) is ROADMAP slice C"
    )


armijo_from_products = armijo_linesearch
