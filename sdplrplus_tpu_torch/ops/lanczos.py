"""Lanczos min-eigenvalue estimation for the dual bound (scalar path).

Counterpart of the JAX package's ``ops/lanczos.py`` (reference: the
randomized Lanczos of src/coreop.jl:461-514). The three-term recurrence
runs on the tensors' device with the matvec S·v of ops/adjoint.apply_S
(a matmul with dense C, one ELL SpMM with sparse C or off-diagonal
constraint entries, S's pattern values assembled once per run), or, in
entry mode, with S assembled densely once (``S_dense``,
ops/entrymask.assemble_S_dense) and one matvec per step; no host sync
per step (breakdown is a mask, as in the JAX loop). The start
vector is drawn from the solve's ``torch.Generator`` (``lanczos_v0``) or
passed in, so tests can hand both packages the same vector.

The tridiagonal eigensolve runs on the host: α and β are (q,) vectors,
and the port's major loop is a host loop that reads them anyway. The
``*_device`` names are kept from the JAX package, whose fused driver
needed the Sturm bisection on the accelerator; the algorithm is the same
(Sturm-count bisection, then two inverse-iteration solves for the
residual safeguard), evaluated in float64.

On a rank-local problem the Krylov vectors are row-sharded and every
inner product of the recurrence is summed across ranks; each rank draws
the whole start vector and keeps its rows, so every world size starts
from the same vector (JAX package: ops/lanczos.py:39-59).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.comm import dp_full, dp_psum, local_rows, n_loc, row_offset
from .adjoint import apply_S, s_tri_for
from .device import DeviceProblem


def _row_mask(dp: DeviceProblem, dtype) -> torch.Tensor:
    """1 on the rows of the problem, 0 on the padding (this rank's rows)."""
    idx = torch.arange(n_loc(dp), device=dp.device)[:, None] + row_offset(dp)
    return (idx < dp.n).to(dtype)


def lanczos_v0(dp: DeviceProblem, generator: torch.Generator,
               dtype) -> torch.Tensor:
    """Random unit start vector (reference: src/coreop.jl:469-471), drawn
    on the host from ``generator`` so a seed gives the same vector on
    every device; a rank keeps its rows of it."""
    v = torch.randn((dp.n_pad, 1), generator=generator, dtype=torch.float64)
    v = local_rows(dp, v).to(dtype=dtype, device=dp.device)
    v = v * _row_mask(dp, dtype)
    return v / torch.sqrt(dp_psum(torch.sum(v * v), dp))


def _matvec(dp: DeviceProblem, y_full, S_dense):
    """v ↦ S·v: one matvec with the dense S of entry mode (its local rows
    times the all-gathered v on a rank-local problem), else apply_S (the
    general path's pattern values assembled here, once)."""
    if S_dense is not None:
        return lambda v: S_dense @ dp_full(dp, v)
    s_tri = s_tri_for(dp, y_full)
    return lambda v: apply_S(dp, y_full, v, s_tri)


def lanczos_alpha_beta_impl(dp: DeviceProblem, y_full, v0, q: int, *,
                            q_max: int, S_dense=None):
    """Run min(q, q_max) Lanczos iterations on S(y_full) from the unit
    start vector ``v0`` (n_pad, 1); returns (alpha, beta, k_eff).

    alpha/beta are (q_max,) with valid prefix of length k_eff (a 0-dim
    tensor); β breakdown (|β| < √n·eps, reference: src/coreop.jl:494)
    stops the recurrence. ``S_dense``: S assembled densely (entry
    mode), each matvec one product."""
    dtype, dev = y_full.dtype, y_full.device
    matvec = _matvec(dp, y_full, S_dense)
    v = v0
    tol = math.sqrt(dp.n) * torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    alpha = torch.zeros(q_max, dtype=dtype, device=dev)
    beta = torch.zeros(q_max, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    v_prev = torch.zeros_like(v)
    beta_prev = zero
    done = torch.zeros((), dtype=torch.bool, device=dev)
    k_eff = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(min(int(q), q_max)):
        Av = matvec(v)
        a_i = dp_psum(torch.sum(v * Av), dp)
        Av = Av - a_i * v - beta_prev * v_prev
        b_i = torch.sqrt(dp_psum(torch.sum(Av * Av), dp))
        active = ~done
        alpha[i] = torch.where(active, a_i, zero)
        beta[i] = torch.where(active, b_i, zero)
        k_eff = torch.where(active, i + 1, k_eff)
        done = done | (b_i < tol)
        v_new = torch.where(done, v, Av / torch.clamp(b_i, min=tiny))
        v_prev = torch.where(done, v_prev, v)
        beta_prev = torch.where(done, beta_prev, b_i)
        v = v_new
    return alpha, beta, k_eff


def lanczos_alpha_beta_reorth_impl(dp: DeviceProblem, y_full, v0, *,
                                   q_max: int, S_dense=None):
    """Lanczos with full reorthogonalization (high-precision path)."""
    dtype, dev = y_full.dtype, y_full.device
    matvec = _matvec(dp, y_full, S_dense)
    v = v0
    tol = math.sqrt(dp.n) * torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    V = torch.zeros((q_max, v.shape[0]), dtype=dtype, device=dev)
    alpha = torch.zeros(q_max, dtype=dtype, device=dev)
    beta = torch.zeros(q_max, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    v_prev = torch.zeros_like(v)
    beta_prev = zero
    done = torch.zeros((), dtype=torch.bool, device=dev)
    k_eff = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(q_max):
        V[i] = torch.where(done, V[i], v[:, 0])
        Av = matvec(v)
        a_i = dp_psum(torch.sum(v * Av), dp)
        Av = Av - a_i * v - beta_prev * v_prev
        for _ in range(2):  # full reorthogonalization, twice
            Av = Av - V.T @ dp_psum(V @ Av, dp)
        b_i = torch.sqrt(dp_psum(torch.sum(Av * Av), dp))
        active = ~done
        alpha[i] = torch.where(active, a_i, zero)
        beta[i] = torch.where(active, b_i, zero)
        k_eff = torch.where(active, i + 1, k_eff)
        done = done | (b_i < tol)
        v_new = torch.where(done, v, Av / torch.clamp(b_i, min=tiny))
        v_prev = torch.where(done, v_prev, v)
        beta_prev = torch.where(done, beta_prev, b_i)
        v = v_new
    return alpha, beta, k_eff


def tridiag_min_eig_resid(alpha, beta, k_eff) -> tuple:
    """(θ_min, margin) for the leading k_eff block of the Lanczos
    tridiagonal — host-side, float64, scipy's eigh_tridiagonal. θ_min is
    the smallest Ritz value; ``margin`` = β_k·|s_k| plus a few-ulp slack,
    so θ_min − margin is the safeguarded λ_min estimate."""
    eps = float(torch.finfo(alpha.dtype).eps) if torch.is_tensor(alpha) \
        else float(np.finfo(np.asarray(alpha).dtype).eps)
    alpha = _np(alpha)
    beta = _np(beta)
    k = int(k_eff)
    if k <= 0:
        return 0.0, 0.0
    a = alpha[:k]
    bfull = beta[:k]
    scale = float(np.max(np.abs(a)) + 2.0 * np.max(np.abs(bfull))) + 1.0
    slack = 32.0 * eps * scale
    if k == 1:
        return float(a[0]), abs(float(bfull[0])) + slack
    b = bfull[: k - 1]
    from scipy.linalg import eigh_tridiagonal

    w, v = eigh_tridiagonal(a, b, select="i", select_range=(0, 0))
    margin = abs(float(bfull[k - 1])) * abs(float(v[-1, 0])) + slack
    return float(w[0]), margin


def tridiag_min_eig(alpha, beta, k_eff) -> float:
    """Smallest eigenvalue of the k_eff×k_eff symmetric tridiagonal (host,
    scipy; the reference's symeigs(:SA), src/coreop.jl:503-511)."""
    alpha, beta = _np(alpha), _np(beta)
    k = int(k_eff)
    if k <= 0:
        return 0.0
    if k == 1:
        return float(alpha[0])
    from scipy.linalg import eigh_tridiagonal

    return float(eigh_tridiagonal(alpha[:k], beta[: k - 1], select="i",
                                  select_range=(0, 0))[0][0])


def lanczos_q(iter_count: int, n: int) -> int:
    """Iteration budget q = 2·⌈max(iter,100)^0.5 · log n⌉ (reference:
    src/coreop.jl:402,465), capped at n."""
    q = int(2 * np.ceil(np.sqrt(max(iter_count, 100)) * np.log(max(n, 2))))
    return max(min(q, n), 1)


def bucket_q_max(q: int, base: int = 64) -> int:
    """Round q up to a power-of-two multiple of ``base``."""
    q_max = base
    while q_max < q:
        q_max *= 2
    return q_max


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _finfo(x):
    return torch.finfo(x.dtype) if torch.is_tensor(x) \
        else np.finfo(np.asarray(x).dtype)


def tridiag_min_eig_device(alpha, beta, k_eff, iters: int = 80) -> float:
    """Smallest eigenvalue of the leading k_eff block of the symmetric
    tridiagonal (alpha, beta) by Sturm-sequence bisection: the count of
    eigenvalues below x comes from the LDLᵀ recurrence
    d_i = (a_i - x) - b_{i-1}²/d_{i-1}; ``iters`` halvings of the
    Gershgorin interval. Same algorithm as the JAX package's device
    solver, run on the host in float64 with the dtype's constants."""
    fi = _finfo(alpha)
    a = _np(alpha).tolist()
    bt = _np(beta).tolist()
    q_max, k = len(a), int(k_eff)
    b2 = [bt[i] * bt[i] if i + 1 < k else 0.0 for i in range(q_max)]
    babs = [abs(bt[i]) if i + 1 < k else 0.0 for i in range(q_max)]
    big = float(fi.max) / 4
    lo, hi = big, -big
    for i in range(k):
        rad = babs[i] + (babs[i - 1] if i > 0 else 0.0)
        lo = min(lo, a[i] - rad)
        hi = max(hi, a[i] + rad)
    if k == 0:
        lo, hi = big, -big
    hi = max(hi, lo + float(fi.eps))
    tiny = float(fi.tiny) * 4

    def any_below(x):
        d_prev = 1.0
        for i in range(k):
            d = (a[i] - x) - (b2[i - 1] / d_prev if i > 0 else 0.0)
            if abs(d) < tiny:
                d = -tiny
            if d < 0:
                return True
            d_prev = d
        return False

    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if any_below(mid):
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def _tridiag_solve(d, e, rhs, k, eps):
    """Thomas-algorithm solve of diag(d) + off-diag(e) (e[i] couples rows
    i, i+1) on the leading k rows; pivots clamped away from zero so a
    shift AT the eigenvalue gives a huge, correctly-directed inverse-
    iteration step. ``d``/``e`` span q_max entries (the scale uses all)."""
    scale = max(abs(x) for x in d) + 2.0 * max(abs(x) for x in e) + 1.0
    tiny = eps * scale

    def clamp(x):
        return (-tiny if x < 0 else tiny) if abs(x) < tiny else x

    dd = [1.0] * k
    bb = [0.0] * k
    for i in range(k):
        w = e[i - 1] / dd[i - 1] if i > 0 else 0.0
        dd[i] = clamp(d[i] - w * (e[i - 1] if i > 0 else 0.0))
        bb[i] = rhs[i] - w * (bb[i - 1] if i > 0 else 0.0)
    x = [0.0] * k
    for i in range(k - 1, -1, -1):
        x[i] = (bb[i] - (e[i] * x[i + 1] if i + 1 < k else 0.0)) / dd[i]
    return x


def tridiag_min_eig_device_certified(alpha, beta, k_eff,
                                     iters: int = 80) -> tuple:
    """(θ_min, margin): Sturm bisection for the smallest Ritz value, then
    two inverse-iteration solves for its eigenvector's last component,
    giving the residual safeguard margin β_k·|s_k| + slack. The certified
    λ_min estimate is θ_min − margin."""
    fi = _finfo(alpha)
    theta = tridiag_min_eig_device(alpha, beta, k_eff, iters)
    a = _np(alpha).tolist()
    bt = _np(beta).tolist()
    q_max, k = len(a), int(k_eff)
    if k <= 0:
        return theta, 0.0
    e = [bt[i] if i + 1 < k else 0.0 for i in range(q_max)]
    d = [a[i] - theta if i < k else 1.0 for i in range(q_max)]
    tiny = float(fi.tiny)
    nrm = lambda v: math.sqrt(max(sum(t * t for t in v), tiny))
    x = [1.0] * k
    x = [t / nrm(x) for t in x]
    for _ in range(2):
        x = _tridiag_solve(d, e, x, k, float(fi.eps))
        x = [t / nrm(x) for t in x]
    scale = max(abs(t) for t in a[:k]) + 2.0 * max(abs(t) for t in e) + 1.0
    slack = 32.0 * float(fi.eps) * scale
    return theta, abs(bt[k - 1]) * abs(x[k - 1]) + slack
