"""The torch inner L-BFGS loop.

Counterpart of the JAX package's ``solver/inner.py`` (reference:
src/sdplr.jl:190-278): direction, descent-direction fallback, line
search (exact quartic, or Armijo backtracking for inequality problems),
the step, the gradient, norms, the fprec stagnation test and the ring
update, one Python iteration per step. This is the engine
``inner_impl="xla"`` names (the name is kept from the JAX package); the
CUDA megakernels (ops/megakernel.py) compute the same loop in one launch.

``use_cx`` selects the fast-diagonal engine (C sparse, every constraint
entry diagonal): one SpMM CD = C@D per iteration feeds both line-search
products, and the gradient comes from the carried recurrence
CX ← CX + α·CD, refreshed exactly at major boundaries (solver/major.py).

Exit conditions: grad_norm <= cur_gtol, stagnation (rel ΔL < stag_tol,
reference: src/sdplr.jl:236-241), or the step budget. The L-BFGS update
is skipped on the stagnation exit.

On a rank-local problem (``dp.spmd``) R, G, CX and the L-BFGS history
are this rank's rows, and the dots over rows are summed across ranks
(the JAX package's inner.py under shard_map); every rank then takes the
same branches.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.adjoint import gradient, gradient_cx
from ..ops.device import DeviceProblem, fast_diag_eligible
from ..ops.forward import A_linesearch_cd
from ..ops.spmm import spmm_C
from ..parallel.comm import dp_psum
from .al import capped_vio
from .lbfgs import LBFGSState, lbfgs_direction, lbfgs_push
from .linesearch import (
    armijo_from_products, armijo_linesearch, exact_from_products,
    exact_linesearch,
)


@dataclasses.dataclass
class InnerCarry:
    R: torch.Tensor
    G: torch.Tensor
    y_full: torch.Tensor
    vio_raw: torch.Tensor
    L_val: torch.Tensor      # 0-dim
    grad_norm: torch.Tensor  # 0-dim
    lbfgs: LBFGSState
    steps: int               # steps taken this chunk
    stagnated: bool
    CX: Any = None           # fast-diagonal engine only: C_sparse @ R


def inner_step(dp: DeviceProblem, c: InnerCarry, lam, sigma, stag_tol, *,
               k: int, use_armijo: bool, gtol_relative: bool,
               lbfgs_compact: bool = True, use_cx: bool = False) -> InnerCarry:
    """One inner L-BFGS iteration (reference: src/sdplr.jl:196-246)."""
    gscale = dp.normC if gtol_relative else 1.0

    # direction + descent fallback (reference: src/sdplr.jl:196-205)
    mesh = dp.spmd
    direction = lbfgs_direction(c.lbfgs, c.G, k, compact=lbfgs_compact,
                                mesh=mesh)
    descent = dp_psum(torch.sum(direction * c.G), dp)
    bad = torch.isnan(descent) | (descent >= 0.0)
    direction = torch.where(bad, -c.G, direction)

    # line search (reference: src/sdplr.jl:210-215), then the step and
    # the gradient (reference: src/sdplr.jl:219-223)
    if use_cx:
        CD = spmm_C(dp, direction)
        A_RD, A_DD = A_linesearch_cd(dp, c.R, direction, CD)
        if use_armijo:
            alpha, L_new, vio_new = armijo_from_products(
                dp, A_RD, A_DD, c.vio_raw, lam, sigma, c.y_full)
        else:
            alpha, L_new, vio_new = exact_from_products(
                dp, A_RD, A_DD, c.vio_raw, lam, sigma)
        R_new = c.R + alpha * direction
        CX_new = c.CX + alpha * CD
        G_new, y_new = gradient_cx(dp, R_new, CX_new, lam, sigma, vio_new)
    else:
        CX_new = c.CX
        if use_armijo:
            alpha, L_new, vio_new = armijo_linesearch(
                dp, c.R, direction, c.vio_raw, lam, sigma, c.y_full)
        else:
            alpha, L_new, vio_new = exact_linesearch(
                dp, c.R, direction, c.vio_raw, lam, sigma)
        R_new = c.R + alpha * direction
        G_new, y_new = gradient(dp, R_new, lam, sigma, vio_new)
    gnorm = torch.sqrt(dp_psum(torch.sum(G_new * G_new), dp)) / gscale

    # fprec stagnation (reference: src/sdplr.jl:236-241)
    one = torch.ones((), dtype=L_new.dtype, device=L_new.device)
    rel_delta = (c.L_val - L_new) / torch.maximum(
        one, torch.maximum(L_new.abs(), c.L_val.abs()))
    stagnated = bool(rel_delta < stag_tol)

    # L-BFGS update, skipped on the stagnation exit
    new_lbfgs = c.lbfgs
    if k > 0 and not stagnated:
        new_lbfgs = lbfgs_push(c.lbfgs, alpha, direction, c.G, G_new, k,
                               mesh=mesh)

    return InnerCarry(R=R_new, G=G_new, y_full=y_new, vio_raw=vio_new,
                      L_val=L_new, grad_norm=gnorm, lbfgs=new_lbfgs,
                      steps=c.steps + 1, stagnated=stagnated, CX=CX_new)


def inner_chunk(dp: DeviceProblem, R, G, y_full, vio_raw, L_val, grad_norm,
                lbfgs: LBFGSState, lam, sigma, cur_gtol, stag_tol,
                max_steps, *, k: int, use_armijo: bool, gtol_relative: bool,
                ptol_relative: bool, lbfgs_compact: bool = True):
    """Run up to ``max_steps`` inner iterations. Returns (carry, vio_norm)."""
    pscale = dp.normb if ptol_relative else 1.0
    use_cx = fast_diag_eligible(dp)
    c = InnerCarry(R=R, G=G, y_full=y_full, vio_raw=vio_raw, L_val=L_val,
                   grad_norm=grad_norm, lbfgs=lbfgs, steps=0, stagnated=False,
                   CX=spmm_C(dp, R) if use_cx else None)
    while (bool(c.grad_norm > cur_gtol) and c.steps < int(max_steps)
           and not c.stagnated):
        c = inner_step(dp, c, lam, sigma, stag_tol, k=k,
                       use_armijo=use_armijo, gtol_relative=gtol_relative,
                       lbfgs_compact=lbfgs_compact, use_cx=use_cx)
    vio_norm = torch.linalg.norm(capped_vio(dp, c.vio_raw)) / pscale
    return c, vio_norm
