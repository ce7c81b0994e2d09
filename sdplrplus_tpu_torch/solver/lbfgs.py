"""L-BFGS over matrix iterates as fixed-shape ring buffers.

Counterpart of the JAX package's ``solver/lbfgs.py`` (reference:
src/lbfgs.jl:1-149). The history is a stacked (k, n_pad, r) pair of
tensors with a ring head index (a Python int); empty slots carry ρ = 0,
which makes their contributions exact no-ops. No H₀ scaling.

Two forms of the same operator H·g: the classic two-loop recursion, and
the Byrd–Nocedal–Schnabel compact representation (Nocedal & Wright,
Thm 7.4 with γ = 1) on the incrementally maintained SᵀY / YᵀY Grams.

In a sharded solve (``mesh`` given) the history is row-sharded like the
factor and every dot over the rows is summed across ranks, as under the
JAX package's shard_map.
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.comm import psum


def _sum(x, mesh):
    return x if mesh is None else psum(x, mesh)


@dataclasses.dataclass
class LBFGSState:
    s_hist: torch.Tensor  # (k, n_pad, r)
    y_hist: torch.Tensor  # (k, n_pad, r)
    rho: torch.Tensor     # (k,)
    head: int             # index of the most recent pair (a 0-dim
    #                       int64 tensor inside the entry loop)
    sty: torch.Tensor     # (k, k) SᵀY Gram (maintained in both forms)
    yty: torch.Tensor     # (k, k) YᵀY Gram


def lbfgs_init(k: int, n_pad: int, r: int, dtype, device="cpu") -> LBFGSState:
    kk = max(k, 1)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return LBFGSState(s_hist=z(kk, n_pad, r), y_hist=z(kk, n_pad, r),
                      rho=z(kk), head=0, sty=z(kk, kk), yty=z(kk, kk))


def lbfgs_clear(state: LBFGSState) -> LBFGSState:
    return LBFGSState(
        s_hist=torch.zeros_like(state.s_hist),
        y_hist=torch.zeros_like(state.y_hist),
        rho=torch.zeros_like(state.rho), head=0,
        sty=torch.zeros_like(state.sty), yty=torch.zeros_like(state.yty),
    )


def lbfgs_direction(state: LBFGSState, G: torch.Tensor, k: int,
                    compact: bool = True, mesh=None) -> torch.Tensor:
    """The negated direction -H·G (reference: src/lbfgs.jl:77-124)."""
    if k == 0:
        return -G
    if compact:
        return _direction_compact(state, G, k, mesh)
    q = G
    a_vals = [None] * k
    for i in range(k):
        j = (state.head - i) % k
        a = state.rho[j] * _sum(torch.sum(state.s_hist[j] * q), mesh)
        q = q - a * state.y_hist[j]
        a_vals[j] = a
    for i in range(k):
        j = (state.head + 1 + i) % k
        bq = state.rho[j] * _sum(torch.sum(state.y_hist[j] * q), mesh)
        q = q + (a_vals[j] - bq) * state.s_hist[j]
    return -q


def _direction_compact(state: LBFGSState, G: torch.Tensor,
                       k: int, mesh=None) -> torch.Tensor:
    """-H·G via the compact representation: two (2k, n·r) contractions
    plus k×k triangular solves."""
    g = G.reshape(-1)
    W = torch.cat([state.s_hist.reshape(k, -1), state.y_hist.reshape(k, -1)])
    p = _sum(W @ g, mesh)
    Sg, Yg = p[:k], p[k:]

    # ring slots oldest first: slot (head + 1 + i) % k has age rank i; the
    # head may be a Python int or a 0-dim device tensor (solver/inner_entry
    # keeps it on the device so a step has no host round trip)
    perm = (torch.arange(k, device=G.device) + (state.head + 1)) % k
    empty = state.rho == 0.0
    mask2 = empty[:, None] | empty[None, :]
    zero = torch.zeros((), dtype=G.dtype, device=G.device)
    sty = torch.where(mask2, zero, state.sty)
    yty = torch.where(mask2, zero, state.yty)
    Rp = torch.triu(sty[perm][:, perm])
    Rp = Rp + torch.diag(empty[perm].to(Rp.dtype))
    Dp = torch.diagonal(sty)[perm]
    YtYp = yty[perm][:, perm]
    Sg_p, Yg_p = Sg[perm], Yg[perm]

    u = torch.linalg.solve_triangular(Rp, Sg_p[:, None], upper=True)[:, 0]
    v = Dp * u + YtYp @ u - Yg_p
    w1 = torch.linalg.solve_triangular(Rp.T, v[:, None], upper=False)[:, 0]
    w = torch.zeros(2 * k, dtype=g.dtype, device=g.device)
    w[perm] = w1
    w[k + perm] = -u
    return -(g + W.T @ w).reshape(G.shape)


def lbfgs_push(state: LBFGSState, alpha, direction, G_old, G_new,
               k: int, mesh=None) -> LBFGSState:
    """Insert s = α·D, y = G_new - G_old, ρ = 1/⟨y, s⟩ at the next ring
    slot and refresh row/column j of the SᵀY / YᵀY Grams. The slot is
    written through a (1,) index tensor, never a host read, so a tensor
    head stays on the device; the returned head has the input's type."""
    if k == 0:
        return state
    j = (state.head + 1) % k
    jj = (j.reshape(1) if torch.is_tensor(j)
          else torch.full((1,), j, dtype=torch.int64, device=G_new.device))
    s = alpha * direction
    y = G_new - G_old
    sy = torch.stack([s.reshape(-1), y.reshape(-1)], dim=1)       # (nr, 2)
    W = torch.cat([state.s_hist.reshape(k, -1),
                   state.y_hist.reshape(k, -1)])                  # OLD history
    PM = _sum(torch.cat([W @ sy, sy.T @ sy]), mesh)   # one reduction
    P, M = PM[:2 * k], PM[2 * k:]                     # (2k, 2), (2, 2)
    ys = M[0, 1]

    sty = state.sty.index_copy(0, jj, P[k:, 0][None, :])
    sty.index_copy_(1, jj, P[:k, 1][:, None])
    sty.index_put_((jj, jj), ys.reshape(1))
    yty = state.yty.index_copy(0, jj, P[k:, 1][None, :])
    yty.index_copy_(1, jj, P[k:, 1][:, None])
    yty.index_put_((jj, jj), M[1, 1].reshape(1))

    s_hist = state.s_hist.index_copy(0, jj, s[None])
    y_hist = state.y_hist.index_copy(0, jj, y[None])
    rho = state.rho.index_copy(0, jj, (1.0 / ys).reshape(1))
    return LBFGSState(s_hist=s_hist, y_hist=y_hist, rho=rho, head=j,
                      sty=sty, yty=yty)
