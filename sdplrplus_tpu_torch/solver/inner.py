"""The torch inner L-BFGS loop (dense engine).

Counterpart of the JAX package's ``solver/inner.py`` (reference:
src/sdplr.jl:190-278): direction, descent-direction fallback, exact
quartic line search, the step, the gradient, norms, the fprec stagnation
test and the ring update, one Python iteration per step. This is the
engine ``inner_impl="xla"`` names (the name is kept from the JAX
package); the CUDA megakernel (ops/megakernel.py) computes the same
loop in one launch.

Exit conditions: grad_norm <= cur_gtol, stagnation (rel ΔL < stag_tol,
reference: src/sdplr.jl:236-241), or the step budget. The L-BFGS update
is skipped on the stagnation exit.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.adjoint import gradient
from ..ops.device import DeviceProblem
from .al import capped_vio
from .lbfgs import LBFGSState, lbfgs_direction, lbfgs_push
from .linesearch import exact_linesearch


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
    CX: Any = None           # fast-diagonal engine only (a later slice)


def inner_step(dp: DeviceProblem, c: InnerCarry, lam, sigma, stag_tol, *,
               k: int, use_armijo: bool, gtol_relative: bool,
               lbfgs_compact: bool = True, use_cx: bool = False) -> InnerCarry:
    """One inner L-BFGS iteration (reference: src/sdplr.jl:196-246)."""
    if use_armijo:
        raise NotImplementedError(
            "the Armijo inner loop (inequality families) is ROADMAP slice C")
    if use_cx:
        raise NotImplementedError(
            "the fast-diagonal ELL engine is ROADMAP slice B")
    gscale = dp.normC if gtol_relative else 1.0

    # direction + descent fallback (reference: src/sdplr.jl:196-205)
    direction = lbfgs_direction(c.lbfgs, c.G, k, compact=lbfgs_compact)
    descent = torch.sum(direction * c.G)
    bad = torch.isnan(descent) | (descent >= 0.0)
    direction = torch.where(bad, -c.G, direction)

    # line search (reference: src/sdplr.jl:210-215)
    alpha, L_new, vio_new = exact_linesearch(
        dp, c.R, direction, c.vio_raw, lam, sigma)

    # step + gradient (reference: src/sdplr.jl:219-223)
    R_new = c.R + alpha * direction
    G_new, y_new = gradient(dp, R_new, lam, sigma, vio_new)
    gnorm = torch.sqrt(torch.sum(G_new * G_new)) / gscale

    # fprec stagnation (reference: src/sdplr.jl:236-241)
    one = torch.ones((), dtype=L_new.dtype, device=L_new.device)
    rel_delta = (c.L_val - L_new) / torch.maximum(
        one, torch.maximum(L_new.abs(), c.L_val.abs()))
    stagnated = bool(rel_delta < stag_tol)

    # L-BFGS update, skipped on the stagnation exit
    new_lbfgs = c.lbfgs
    if k > 0 and not stagnated:
        new_lbfgs = lbfgs_push(c.lbfgs, alpha, direction, c.G, G_new, k)

    return InnerCarry(R=R_new, G=G_new, y_full=y_new, vio_raw=vio_new,
                      L_val=L_new, grad_norm=gnorm, lbfgs=new_lbfgs,
                      steps=c.steps + 1, stagnated=stagnated)


def inner_chunk(dp: DeviceProblem, R, G, y_full, vio_raw, L_val, grad_norm,
                lbfgs: LBFGSState, lam, sigma, cur_gtol, stag_tol,
                max_steps, *, k: int, use_armijo: bool, gtol_relative: bool,
                ptol_relative: bool, lbfgs_compact: bool = True):
    """Run up to ``max_steps`` inner iterations. Returns (carry, vio_norm)."""
    pscale = dp.normb if ptol_relative else 1.0
    c = InnerCarry(R=R, G=G, y_full=y_full, vio_raw=vio_raw, L_val=L_val,
                   grad_norm=grad_norm, lbfgs=lbfgs, steps=0, stagnated=False)
    while (bool(c.grad_norm > cur_gtol) and c.steps < int(max_steps)
           and not c.stagnated):
        c = inner_step(dp, c, lam, sigma, stag_tol, k=k,
                       use_armijo=use_armijo, gtol_relative=gtol_relative,
                       lbfgs_compact=lbfgs_compact)
    vio_norm = torch.linalg.norm(capped_vio(dp, c.vio_raw)) / pscale
    return c, vio_norm
