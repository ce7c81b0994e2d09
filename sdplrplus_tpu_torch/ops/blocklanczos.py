"""Block Lanczos min-eigenvalue estimation for the dual bound.

Counterpart of the JAX package's ``ops/blocklanczos.py``: the recurrence
runs on an (n, b) block, so each step is ONE operator pass carrying b
Krylov vectors (on the fast-diagonal engine one ELL SpMM, whose row
gather costs the same for 1 or 16 lanes); the start block is seeded with
the primal factor R, whose range spans the near-null space of S at the
least-squares multiplier; the basis is kept and fully reorthogonalized
twice per step; the loop exits early once the residual safeguard meets
its target, confirmed by running on to twice the depth (hit, then
double).

The certified estimate is θ_min − margin with margin = ‖B_k·u_last‖ +
64·eps·scale, eps the working dtype's: the block analog of the scalar
path's β_k·|s_k| bound (ops/lanczos.py).

Differences from the JAX package, by design:

  * ``lax.while_loop`` becomes a Python loop; the control flow (breakdown,
    the check schedule, the hit-then-double confirmation) reads one flag
    from the device per step.
  * The projected block-tridiagonal problem (at most 512 columns) is
    solved on the host in float64 with scipy's ``eigh`` on its active
    k_eff·b leading block. The JAX package tridiagonalizes it on the
    device with Householder and Sturm bisection only because ``eigh`` does
    not compile inside its ``while_loop``.
  * Partial breakdown deflates instead of stopping. CholQR flags a block
    whose columns are dependent relative to its largest; the JAX package
    then ends the recurrence as if the subspace were invariant. That is
    wrong when only some lanes have converged, which is what a factor-
    seeded start block does at a converged factor: range(R) is nearly an
    eigenspace of S, so its residual lanes vanish on the first step while
    the random lanes do not. The recurrence then stops after one step
    without the hit-then-double confirmation and certifies the Ritz value
    nearest to range(R), not λ_min (SYN20K in float32 on the CPU: a
    claimed gap of 1.2e-3 where float64 ``eigsh`` at the same multiplier
    gives 1.07e-2). Here the dependent directions of such a block are
    dropped (their residual norm is added to the margin) and replaced by
    fresh random directions orthogonal to the basis, and the recurrence
    goes on; it stops on breakdown only when the whole block vanishes
    (an invariant subspace), when no room is left for another block, or
    on a non-finite step, as the JAX package does.

On a rank-local problem the blocks are row-sharded: every Gram matrix
and projection coefficient is summed across ranks, and each rank draws
the whole random block and keeps its rows (JAX package:
ops/blocklanczos.py:84-85), so every world size runs the same recurrence.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.comm import dp_full, dp_psum, local_rows
from .adjoint import apply_S, s_tri_for
from .device import DeviceProblem
from .lanczos import _row_mask


def block_sizes(n: int, r: int, block: int = 0) -> tuple:
    """(b, k_max) for a problem of size n with current primal rank r.

    ``block`` > 0 forces the block size. Defaults: b covers the factor's
    rank sketch plus a few random exploration lanes, a multiple of 8 in
    [16, 32]; k_max caps the total subspace at min(512, ~n/2) columns."""
    if block > 0:
        b = block
    else:
        b = min(32, max(16, 8 * ((min(r, 24) + 4 + 7) // 8)))
    k_max = max(4, min(512 // b, max(8, n // (2 * b))))
    return b, k_max


def _draw(generator: torch.Generator, shape, dtype, device):
    """Normal draws on the host in float64 from ``generator`` (so a seed
    gives the same numbers on every device), cast to dtype on device."""
    x = torch.randn(shape, generator=generator, dtype=torch.float64)
    return x.to(dtype=dtype, device=device)


def _seed_block(dp: DeviceProblem, generator, R, b: int, dtype,
                draws=None):
    """Start block: a random sketch R·G of range(R) in the first
    b1 = min(r, max(b − 4, 1)) lanes, scaled to unit column norms, and
    fresh normal lanes after them. Row-masked, not yet orthonormal (the
    caller CholQR-orthonormalizes). ``draws`` = (V_full (n_pad, b),
    G (r, b1)) hands in the random numbers, so tests can give both
    packages the same; else both come from ``generator``. A rank keeps
    its rows of V."""
    dev = dp.device
    r = R.shape[1] if R is not None else 0
    b1 = min(r, max(b - 4, 1))
    if draws is None:
        V = _draw(generator, (dp.n_pad, b), dtype, dev)
        G = _draw(generator, (r, b1), dtype, dev) if r > 0 else None
    else:
        V = torch.as_tensor(np.array(draws[0]), dtype=dtype, device=dev)
        G = (torch.as_tensor(np.array(draws[1]), dtype=dtype, device=dev)
             if r > 0 else None)
    V = local_rows(dp, V).clone()
    if r > 0:
        sk = R @ G
        nrm = torch.sqrt(torch.clamp(dp_psum(torch.sum(sk * sk, dim=0), dp),
                                     min=torch.finfo(dtype).tiny))
        V[:, :b1] = sk / nrm
    return V * _row_mask(dp, dtype)


def _cholqr(W, eps_scale, dp=None):
    """Column-scaled CholQR: W = Q·B with Q orthonormal and B upper
    triangular. Returns (Q, B, fail); ``fail`` flags a block whose columns
    are dependent (relative to the largest) or that vanished altogether.

    The Gram matrix is normalized by the column norms before the
    Cholesky, so the rank test is scale-invariant; columns more than
    about three decades below the block's largest are rounding noise and
    their normalizer is clamped, so they show up as dependence instead of
    being boosted into fake directions. A Cholesky that breaks down
    (``cholesky_ex`` info > 0, where ``jnp.linalg.cholesky`` returns NaN)
    is a failure with B = 0. On failure Q is unused. W may be a
    rank-local row block of ``dp``'s (the Gram is then summed)."""
    dtype = W.dtype
    eps_scale = torch.as_tensor(eps_scale, dtype=dtype, device=W.device)
    G = dp_psum(W.T @ W, dp)
    b = G.shape[0]
    eps = torch.finfo(dtype).eps
    eye = torch.eye(b, dtype=dtype, device=W.device)
    d = torch.sqrt(torch.diagonal(G))
    dmax = torch.max(d)
    floor = torch.maximum(1024.0 * eps * dmax, eps * (eps_scale + 1.0))
    ds = torch.maximum(d, floor)
    Gn = G / (ds[:, None] * ds[None, :])
    jit = 4.0 * eps
    Ln, info = torch.linalg.cholesky_ex(Gn + jit * eye)
    broke = info != 0
    Ln = torch.where(broke | ~torch.isfinite(Ln), torch.zeros_like(Ln), Ln)
    dmin = torch.min(torch.abs(torch.diagonal(Ln)))
    fail = broke | (dmin * dmin <= 16.0 * jit) \
        | ~(dmax > eps * (eps_scale + 1.0))
    Ln_safe = torch.where(fail, eye, Ln)
    # G = (D·Ln)(D·Ln)ᵀ, so W = Q·B with B = Lnᵀ·D and Q = (W·D⁻¹)·Ln⁻ᵀ
    Q = torch.linalg.solve_triangular(Ln_safe.T, W / ds[None, :],
                                      upper=True, left=False)
    B = Ln.T * ds[None, :]
    return Q, B, fail


def block_tridiag_min_eig_certified(A_blocks, B_blocks, k_eff):
    """(θ_min, margin, ok) for the leading k_eff blocks of the block
    tridiagonal with diagonal blocks A_blocks and sub-diagonal couplings
    B_blocks (block j+1 below block j). Solved on the host in float64:
    θ_min and its eigenvector u from ``scipy.linalg.eigh`` of the active
    k_eff·b leading block; margin = ‖B_{k_eff−1}·u_last‖ + 64·eps·scale
    with the working dtype's eps and scale = max|A| + 2·max|B| + 1 over the
    active blocks. With k_eff = 0: (4·scale, 4·scale, False), as the
    JAX package's masked solve gives."""
    eps = float(torch.finfo(A_blocks.dtype).eps) \
        if torch.is_tensor(A_blocks) else float(np.finfo(
            np.asarray(A_blocks).dtype).eps)
    A = _np64(A_blocks)
    Bb = _np64(B_blocks)
    b = A.shape[1]
    k = int(k_eff)
    if k <= 0:
        return 4.0, 4.0, False
    scale = (float(np.max(np.abs(A[:k]))) + 2.0 * float(np.max(np.abs(Bb[:k])))
             + 1.0)
    p = k * b
    T = np.zeros((p, p))
    for j in range(k):
        T[j * b:(j + 1) * b, j * b:(j + 1) * b] = A[j]
        if j + 1 < k:
            T[(j + 1) * b:(j + 2) * b, j * b:(j + 1) * b] = Bb[j]
            T[j * b:(j + 1) * b, (j + 1) * b:(j + 2) * b] = Bb[j].T
    from scipy.linalg import eigh

    w, v = eigh(T, subset_by_index=(0, 0))
    u_last = v[(k - 1) * b:, 0]
    res = Bb[k - 1] @ u_last
    margin = float(np.sqrt(np.sum(res * res))) + 64.0 * eps * scale
    return float(w[0]), margin, True


def _np64(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _deflate(dp, W, hist_j, scale, generator, row_mask):
    """Orthonormalize a block whose columns CholQR found dependent: keep
    the directions of W's column-normalized Gram above CholQR's rank
    threshold, replace the rest with fresh normal directions orthogonal to
    the basis ``hist_j`` (j, n, b) and to the kept ones. Returns
    (Q, B, dropped, ok) with W = Q·B + E, ‖E‖₂ = ``dropped`` (the norm of
    the discarded residual, float64 on the host) and ``ok`` False when
    nothing is left to keep or no fresh direction fits."""
    dtype, dev = W.dtype, W.device
    b = W.shape[1]
    eps = float(torch.finfo(dtype).eps)
    G = _np64(dp_psum(W.T @ W, dp))
    d = np.sqrt(np.maximum(np.diagonal(G), 0.0))
    dmax = float(np.max(d))
    ds = np.maximum(d, max(1024.0 * eps * dmax, eps * (scale + 1.0)))
    s, U = np.linalg.eigh(G / np.outer(ds, ds))
    keep = s > 64.0 * eps          # CholQR's rank test: dmin² ≤ 16·jit
    nk = int(np.sum(keep))
    if nk == 0 or nk == b:
        return None, None, 0.0, False
    Uk, sk = U[:, keep], s[keep]
    Ud, sd = U[:, ~keep], np.maximum(s[~keep], 0.0)
    # W·D⁻¹ = Wn; Wnᵀ·Wn = U·diag(s)·Uᵀ. Q_keep = Wn·U_k·s_k^(-1/2) and
    # B_keep = s_k^(1/2)·U_kᵀ·D give W = Q_keep·B_keep + Wn·U_d·U_dᵀ·D;
    # the dropped part E has EᵀE = D·U_d·diag(s_d)·U_dᵀ·D
    E2 = (ds[:, None] * Ud) @ np.diag(sd) @ (Ud.T * ds[None, :])
    dropped = float(np.sqrt(max(np.linalg.eigvalsh(E2)[-1], 0.0)))
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    Qk = (W / t(ds)[None, :]) @ t(Uk / np.sqrt(sk)[None, :])
    Bk = t(np.sqrt(sk)[:, None] * Uk.T * ds[None, :])
    Qk, Bf, f = _cholqr(Qk, 1.0, dp)      # restore orthonormality
    if bool(f):
        return None, None, 0.0, False
    Bk = Bf @ Bk
    Z = local_rows(dp, _draw(generator, (dp.n_pad, b - nk), dtype, dev))
    Z = Z * row_mask
    for _ in range(2):
        Z = Z - torch.einsum("knb,kbc->nc", hist_j, dp_psum(
            torch.einsum("knb,nc->kbc", hist_j, Z), dp))
        Z = Z - Qk @ dp_psum(Qk.T @ Z, dp)
    Zq, _, f1 = _cholqr(Z, 1.0, dp)
    Zq, _, f2 = _cholqr(Zq, 1.0, dp)
    if bool(f1 | f2):
        return None, None, 0.0, False
    Q = torch.cat([Qk, Zq], dim=1)
    B = torch.cat([Bk, torch.zeros((b - nk, b), dtype=dtype, device=dev)])
    return Q, B, dropped, True


def block_lanczos_min_eig(dp: DeviceProblem, y_full, generator, R,
                          margin_target, k_min, *, b: int, k_max: int,
                          check_every: int = 2, seed_draws=None,
                          S_dense=None):
    """Certified λ_min estimate of S(y_full) via R-seeded block Lanczos.

    Returns (theta, margin, k_used): the safeguarded estimate is
    θ − margin. The loop stops at the first checked step where
    margin ≤ margin_target or θ − margin ≥ 0, once confirmed at twice that
    depth; or on breakdown; or after k_max steps. ``k_min`` forces a
    minimum Krylov depth. θ and margin are rounded to the working dtype,
    where the JAX package keeps them. ``seed_draws`` hands the start
    block's random numbers in (see ``_seed_block``). ``S_dense``: S
    assembled densely (entry mode), each block step one product."""
    dtype, dev = y_full.dtype, y_full.device
    s_tri = s_tri_for(dp, y_full) if S_dense is None else None
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    rnd = lambda x: float(np_dtype(x))
    margin_target = rnd(margin_target)
    k_min = int(k_min)
    one = torch.ones((), dtype=dtype, device=dev)

    V0 = _seed_block(dp, generator, R, b, dtype, seed_draws)
    V0, _, _ = _cholqr(V0, one, dp)
    V0, _, _ = _cholqr(V0, one, dp)  # CholQR2
    n_loc = V0.shape[0]
    mask = _row_mask(dp, dtype)

    BIGM = rnd(np.finfo(np.float32).max / 8)
    hist = torch.zeros((k_max, n_loc, b), dtype=dtype, device=dev)
    A_blocks = torch.zeros((k_max, b, b), dtype=dtype, device=dev)
    B_blocks = torch.zeros((k_max, b, b), dtype=dtype, device=dev)
    V, V_prev = V0, torch.zeros_like(V0)
    B_prev = torch.zeros((b, b), dtype=dtype, device=dev)
    theta, margin = 0.0, BIGM
    j_hit, theta_hit = -1, 0.0
    defl2 = 0.0               # Σ‖E‖² of the deflated steps' dropped parts
    j = 0
    while j < k_max:
        hist[j] = V
        W = S_dense @ dp_full(dp, V) if S_dense is not None \
            else apply_S(dp, y_full, V, s_tri)
        W = W - V_prev @ B_prev.T
        A_j = dp_psum(V.T @ W, dp)
        A_j = 0.5 * (A_j + A_j.T)
        W = W - V @ A_j
        # full two-pass reorthogonalization against the stored basis
        Hm = hist[:j + 1]
        for _ in range(2):
            W = W - torch.einsum("knb,kbc->nc", Hm, dp_psum(
                torch.einsum("knb,nc->kbc", Hm, W), dp))
        scale = torch.sqrt(torch.clamp(dp_psum(torch.sum(V * V), dp),
                                       min=1.0))
        # CholQR2: the second pass squares the first's loss of
        # orthogonality away. Composite factor: W = Q·(B2·B1)
        Q1, B1, f1 = _cholqr(W, scale, dp)
        Q, B2, f2 = _cholqr(Q1, one, dp)
        B_j = B2 @ B1
        san = bool(torch.all(torch.isfinite(A_j))
                   & torch.all(torch.isfinite(B_j)))
        fail = bool(f1 | f2) or not san
        if fail and san:
            # partial breakdown: deflate unless the block vanished as a
            # whole (invariant subspace) or no room is left for a block
            eps = torch.finfo(dtype).eps
            colsq = dp_psum(torch.sum(W * W, 0), dp)
            vanished = not bool(torch.max(torch.sqrt(colsq))
                                > eps * (scale + 1.0))
            if not vanished and (j + 2) * b <= dp.n:
                Qd, Bd, dropped, ok = _deflate(dp, W, Hm, float(scale),
                                               generator, mask)
                if ok:
                    Q, B_j, fail = Qd, Bd, False
                    defl2 += dropped * dropped
        A_blocks[j] = A_j if san else 0.0
        B_blocks[j] = B_j if san else 0.0

        # check only where it can still change the outcome: a hit at
        # j + 1 > k_max/2 can never be confirmed at twice its depth
        can_arm = 2 * (j + 1) <= k_max
        can_confirm = j_hit > 0 and j + 1 >= 2 * j_hit
        on_schedule = j + 1 >= k_min and (j + 1 - k_min) % check_every == 0
        do_check = ((on_schedule and can_arm)
                    or (j + 1 >= k_min and can_confirm)
                    or fail or j + 1 >= k_max)
        k_chk = j + 1 if san else j  # skip a dropped garbage block
        if do_check:
            th, mg, ok = block_tridiag_min_eig_certified(
                A_blocks, B_blocks, k_chk)
            mg = rnd(mg + math.sqrt(defl2)) if ok else BIGM
            # keep the best (smallest-margin) certified state so far
            if mg < margin:
                theta, margin = rnd(th), mg
        # hit-then-double: the first step that meets the target arms the
        # exit; the loop must reach twice that depth with θ stable (a
        # drop of less than a quarter target) to stop, and a further drop
        # re-arms it
        hit = do_check and (margin <= margin_target
                            or rnd(theta - margin) >= 0)
        dropped_th = theta < rnd(theta_hit - 0.25 * margin_target)
        if hit and (j_hit < 0 or dropped_th):
            j_hit, theta_hit = j + 1, theta
        confirmed = (hit and j_hit > 0 and not dropped_th
                     and j + 1 >= 2 * j_hit)
        V_prev, V, B_prev = V, Q, B_j
        j += 1
        if fail or confirmed:
            break
    # guarantee a final check (the loop may end on k_max between checks)
    if margin >= BIGM:
        th, mg, ok = block_tridiag_min_eig_certified(A_blocks, B_blocks, j)
        theta, margin = rnd(th), (rnd(mg + math.sqrt(defl2)) if ok
                                  else BIGM)
    return theta, margin, j
