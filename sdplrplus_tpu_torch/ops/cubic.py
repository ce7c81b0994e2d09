"""Closed-form cubic root solve for the exact quartic line search.

Counterpart of the JAX package's ``ops/cubic.py``: the derivative cubic
of the quartic AL restriction is solved in closed form (Cardano /
trigonometric method), with degenerate leading coefficients handled by
select (reference: src/linesearch.jl:58-112). All inputs are 0-dim
tensors of one dtype.
"""

from __future__ import annotations

import math

import torch


def cubic_real_roots(a, b, c, d, eps=None):
    """Real roots of a·x³ + b·x² + c·x + d = 0 as a length-3 tensor;
    invalid slots are NaN."""
    dtype = a.dtype
    if eps is None:
        eps = torch.finfo(dtype).eps
    nan = torch.full((), math.nan, dtype=dtype, device=a.device)
    one = torch.ones((), dtype=dtype, device=a.device)

    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          torch.maximum(c.abs(), d.abs())) + eps
    is_cubic = a.abs() > eps * scale
    is_quad = b.abs() > eps * scale

    # linear: c·x + d = 0
    lin_root = -d / torch.where(c.abs() > 0, c, one)
    lin_roots = torch.stack([lin_root, nan, nan])

    # quadratic: b·x² + c·x + d = 0
    b_safe = torch.where(is_quad, b, one)
    disc_q = c * c - 4.0 * b_safe * d
    sq = torch.sqrt(torch.clamp(disc_q, min=0.0))
    q1 = (-c + sq) / (2.0 * b_safe)
    q2 = (-c - sq) / (2.0 * b_safe)
    qvalid = disc_q >= 0.0
    quad_roots = torch.stack([torch.where(qvalid, q1, nan),
                              torch.where(qvalid, q2, nan), nan])

    # cubic, depressed form t³ + p·t + q with x = t - b/(3a)
    a_safe = torch.where(is_cubic, a, one)
    bb = b / a_safe
    cc = c / a_safe
    dd = d / a_safe
    p = cc - bb * bb / 3.0
    q = 2.0 * bb ** 3 / 27.0 - bb * cc / 3.0 + dd
    shift = -bb / 3.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # one real root (disc > 0): Cardano
    sdisc = torch.sqrt(torch.clamp(disc, min=0.0))
    u = _cbrt(-q / 2.0 + sdisc)
    v = _cbrt(-q / 2.0 - sdisc)
    single = u + v + shift

    # three real roots (disc <= 0): trigonometric method
    pm = torch.clamp(p, max=-eps)
    rr = torch.sqrt(-pm / 3.0)
    cos_arg = torch.clamp(3.0 * q / (2.0 * pm * rr), -1.0, 1.0)
    phi = torch.arccos(cos_arg)
    k = torch.arange(3, dtype=dtype, device=a.device)
    triple = 2.0 * rr * torch.cos((phi - 2.0 * math.pi * k) / 3.0) + shift

    one_real = disc > 0.0
    cubic_roots = torch.where(one_real, torch.stack([single, nan, nan]),
                              triple)
    return torch.where(is_cubic, cubic_roots,
                       torch.where(is_quad, quad_roots, lin_roots))


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def minimize_quartic(coeffs, alpha_max):
    """argmin over [0, alpha_max] of e + d·α + c·α² + b·α³ + a·α⁴.

    ``coeffs`` = (e, d, c, b, a). Candidates are the real stationary
    points clipped into the interval plus both endpoints. The derivative
    coefficients are normalized by their largest magnitude first so the
    Cardano intermediates cannot overflow float32.
    Returns (alpha_star, f_star)."""
    e, d, c, b, a = coeffs
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          torch.maximum(c.abs(), d.abs()))
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    roots = cubic_real_roots(4.0 * a / scale, 3.0 * b / scale,
                             2.0 * c / scale, d / scale)
    # a fill, not a host-to-device copy, so the entry loop's step can be
    # captured in a CUDA graph (solver/inner_entry.py)
    alpha_max = (alpha_max.to(e.dtype) if torch.is_tensor(alpha_max)
                 else torch.full_like(e, alpha_max))
    zero = torch.zeros_like(alpha_max)
    cands = torch.cat([roots, torch.stack([alpha_max, zero])])
    cands = torch.where(torch.isnan(cands), zero,
                        torch.minimum(torch.clamp(cands, min=0.0), alpha_max))
    f = e + cands * (d + cands * (c + cands * (b + cands * a)))
    # gather, not f[i]: a 0-dim index tensor would be read on the host
    i = torch.argmin(f).reshape(1)
    return cands.gather(0, i).reshape(()), f.gather(0, i).reshape(())
