"""The inner L-BFGS loop in entrywise dense-mask form (ops/entrymask.py).

Counterpart of the JAX package's ``solver/inner_entry.py``: the state
machine of solver/inner.py (reference: src/sdplr.jl:190-278), with the
violations carried as a dense masked (n_pad, n_pad) matrix instead of the
m-vector, so an iteration is matmuls and masked reductions with no
per-constraint gathers. The m-vector is materialized only at the chunk
boundary (``entry_split`` / ``entry_merge``), and the chunk returns the
standard (InnerCarry, vio_norm) pair, so solver/major.py plugs it in
like the megakernels. The JAX loop is a ``lax.while_loop``; here it is a
Python ``while`` over ``entry_step``, as solver/inner.py runs its loop.

A step reads nothing on the host: the ring head and the stagnation flag
stay device tensors, and a stagnated step keeps the ring by selection.
So on the card the step is captured once per problem and rank as a CUDA
graph (``_EntryGraph``) and replayed, with one host read per step for the
loop's exit test: the eager step is a few hundred small launches, which
hold the card idle most of each iteration. The graph runs the same
operations on the same buffers; ``graph=False`` runs them eagerly.

On a rank-local problem the masks and the carried v_ew are this rank's
row block (ops/entrymask.py) and the dots over rows are summed across
ranks. The step is captured as a graph only where its collectives can
be: on one device or an NCCL mesh. A gloo mesh stages every collective
through host memory, which a graph cannot hold, so it runs the eager
step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.device import DeviceProblem
from ..ops.entrymask import (
    apply_C_entry,
    entry_lam,
    entry_merge,
    entry_split,
    gradient_entry,
    linesearch_entry,
    vio_norm_entry,
)
from ..parallel.comm import dp_psum
from .inner import InnerCarry
from .lbfgs import LBFGSState, lbfgs_direction, lbfgs_push


@dataclasses.dataclass
class EntryCarry:
    R: torch.Tensor
    G: torch.Tensor
    CR: torch.Tensor        # C @ R, kept incrementally (CR += α·CD)
    v_ew: torch.Tensor      # (n_pad, n_pad) masked violations
    v_ex: torch.Tensor      # (n_ex,) wide and low-rank constraint violations
    obj: torch.Tensor       # ⟨C, RRᵀ⟩
    L_val: torch.Tensor
    grad_norm: torch.Tensor
    lbfgs: LBFGSState       # head: 0-dim int64 tensor
    steps: int
    stagnated: torch.Tensor  # 0-dim bool


_TENSOR_FIELDS = ("R", "G", "CR", "v_ew", "v_ex", "obj", "L_val",
                  "grad_norm", "stagnated")
_RING_FIELDS = ("s_hist", "y_hist", "rho", "head", "sty", "yty")


def entry_step(dp: DeviceProblem, c: EntryCarry, Lam_ew, lam_ex, sigma,
               stag_tol, *, k: int, gtol_relative: bool,
               lbfgs_compact: bool) -> EntryCarry:
    """One inner iteration (reference: src/sdplr.jl:196-246), all state in
    dense-mask form, with no host read."""
    gscale = dp.normC if gtol_relative else 1.0

    direction = lbfgs_direction(c.lbfgs, c.G, k, compact=lbfgs_compact,
                                mesh=dp.spmd)
    descent = dp_psum(torch.sum(direction * c.G), dp)
    bad = torch.isnan(descent) | (descent >= 0.0)
    direction = torch.where(bad, -c.G, direction)

    ls = linesearch_entry(dp, c.R, direction, c.v_ew, c.v_ex, c.obj,
                          Lam_ew, lam_ex, sigma)
    R_new = c.R + ls.alpha * direction
    CR_new = c.CR + ls.alpha * ls.CD
    G_new = gradient_entry(dp, R_new, CR_new, ls.v_ew, ls.v_ex, Lam_ew,
                           lam_ex, sigma)
    gnorm = torch.sqrt(dp_psum(torch.sum(G_new * G_new), dp)) / gscale

    one = torch.ones((), dtype=ls.L_new.dtype, device=ls.L_new.device)
    rel_delta = (c.L_val - ls.L_new) / torch.maximum(
        one, torch.maximum(ls.L_new.abs(), c.L_val.abs()))
    stagnated = rel_delta < stag_tol

    new_lbfgs = c.lbfgs
    if k > 0:
        # a stagnated step pushes no pair: keep the old ring by selection
        pushed = lbfgs_push(c.lbfgs, ls.alpha, direction, c.G, G_new, k,
                            mesh=dp.spmd)
        new_lbfgs = LBFGSState(**{
            f: torch.where(stagnated, getattr(c.lbfgs, f), getattr(pushed, f))
            for f in _RING_FIELDS})

    return EntryCarry(R=R_new, G=G_new, CR=CR_new, v_ew=ls.v_ew,
                      v_ex=ls.v_ex, obj=ls.obj, L_val=ls.L_new,
                      grad_norm=gnorm, lbfgs=new_lbfgs, steps=c.steps + 1,
                      stagnated=stagnated)


def _copy_state(dst: EntryCarry, src: EntryCarry):
    """In-place copy of every tensor of ``src`` into ``dst``'s buffers."""
    for f in _TENSOR_FIELDS:
        getattr(dst, f).copy_(getattr(src, f))
    for f in _RING_FIELDS:
        getattr(dst.lbfgs, f).copy_(getattr(src.lbfgs, f))


def _clone_state(c: EntryCarry) -> EntryCarry:
    return dataclasses.replace(
        c, lbfgs=LBFGSState(**{f: getattr(c.lbfgs, f).clone()
                               for f in _RING_FIELDS}),
        **{f: getattr(c, f).clone() for f in _TENSOR_FIELDS})


class _EntryGraph:
    """One entry step captured as a CUDA graph on static buffers: the
    carry, the major iteration's fixed inputs (Λ, λ_ex, σ) and the loop's
    thresholds are loaded by copy before a run, and each replay advances
    the carry in place and sets ``cont`` = ‖G‖ > gtol and not stagnated."""

    def __init__(self, dp, c: EntryCarry, Lam_ew, lam_ex, sigma, stag_tol,
                 cur_gtol, *, k: int, gtol_relative: bool):
        self.dp, self.k, self.gtol_relative = dp, k, gtol_relative
        self.key = _graph_key(dp, c, k, gtol_relative)
        self.c = _clone_state(c)
        self.Lam_ew, self.lam_ex = Lam_ew.clone(), lam_ex.clone()
        self.sigma, self.stag_tol = sigma.clone(), stag_tol.clone()
        self.cur_gtol = cur_gtol.clone()
        self.cont = torch.zeros((), dtype=torch.bool, device=c.R.device)
        # warm-up on a side stream (library handles and workspaces are
        # made outside the capture), then capture one step
        side = torch.cuda.Stream(device=c.R.device)
        side.wait_stream(torch.cuda.current_stream(c.R.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._body()
        torch.cuda.current_stream(c.R.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._body()

    def _body(self):
        n = entry_step(self.dp, self.c, self.Lam_ew, self.lam_ex, self.sigma,
                       self.stag_tol, k=self.k,
                       gtol_relative=self.gtol_relative, lbfgs_compact=True)
        self.cont.copy_((n.grad_norm > self.cur_gtol) & ~n.stagnated)
        _copy_state(self.c, n)

    def run(self, c: EntryCarry, Lam_ew, lam_ex, sigma, stag_tol, cur_gtol,
            max_steps: int) -> EntryCarry:
        _copy_state(self.c, c)
        for dst, src in ((self.Lam_ew, Lam_ew), (self.lam_ex, lam_ex),
                         (self.sigma, sigma), (self.stag_tol, stag_tol),
                         (self.cur_gtol, cur_gtol)):
            dst.copy_(src)
        steps = 0
        go = bool(c.grad_norm > self.cur_gtol)
        while go and steps < max_steps:
            self.graph.replay()
            steps += 1
            go = bool(self.cont)
        out = _clone_state(self.c)
        out.steps = c.steps + steps
        return out


def _graph_key(dp, c: EntryCarry, k: int, gtol_relative: bool):
    return (id(dp), tuple(c.R.shape), c.R.dtype, c.R.device, k,
            gtol_relative)


class EntryGraphs:
    """The captured entry step of one solve: at most one graph, for the
    problem and rank in use; another problem or rank replaces it, and the
    graph's memory goes with the solve that made this object."""

    def __init__(self):
        self._g = None

    def get(self, dp, c, Lam_ew, lam_ex, sigma, stag_tol, cur_gtol, *,
            k: int, gtol_relative: bool) -> _EntryGraph:
        key = _graph_key(dp, c, k, gtol_relative)
        if self._g is None or self._g.key != key or self._g.dp is not dp:
            self._g = None          # free the old graph's pool first
            self._g = _EntryGraph(dp, c, Lam_ew, lam_ex, sigma, stag_tol,
                                  cur_gtol, k=k, gtol_relative=gtol_relative)
        return self._g


def entry_chunk(dp: DeviceProblem, R, G, vio_raw, L_val, grad_norm,
                lbfgs: LBFGSState, lam, sigma, cur_gtol, stag_tol,
                max_steps, *, k: int, gtol_relative: bool,
                ptol_relative: bool, lbfgs_compact: bool = True,
                graph: bool | None = None,
                graphs: EntryGraphs | None = None):
    """Run up to ``max_steps`` entry-mode inner iterations. m-vector in,
    m-vector out: returns the standard (InnerCarry, vio_norm) pair.
    ``graph`` (default: on CUDA tensors with the compact L-BFGS form and
    k > 0, on one device or an NCCL mesh) replays the step as a CUDA
    graph, kept in ``graphs`` across calls (else captured for this
    call); the eager loop otherwise."""
    dtype, dev = R.dtype, R.device
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    pscale = dp.normb if ptol_relative else 1.0
    v_ew, v_ex, obj = entry_split(dp, vio_raw)
    Lam_ew, lam_ex = entry_lam(dp, lam)
    head = torch.full((), lbfgs.head, dtype=torch.int64, device=dev)
    c = EntryCarry(R=R, G=G, CR=apply_C_entry(dp, R), v_ew=v_ew, v_ex=v_ex,
                   obj=obj, L_val=t(L_val), grad_norm=t(grad_norm),
                   lbfgs=dataclasses.replace(lbfgs, head=head), steps=0,
                   stagnated=torch.zeros((), dtype=torch.bool, device=dev))
    sigma, stag_tol, cur_gtol = t(sigma), t(stag_tol), t(cur_gtol)
    if graph is None:
        graph = (R.is_cuda and lbfgs_compact and k > 0
                 and (dp.spmd is None or dp.spmd.backend == "nccl"))
    if graph:
        g = (graphs or EntryGraphs()).get(
            dp, c, Lam_ew, lam_ex, sigma, stag_tol, cur_gtol, k=k,
            gtol_relative=gtol_relative)
        c = g.run(c, Lam_ew, lam_ex, sigma, stag_tol, cur_gtol,
                  int(max_steps))
    else:
        go = bool(c.grad_norm > cur_gtol)
        while go and c.steps < int(max_steps):
            c = entry_step(dp, c, Lam_ew, lam_ex, sigma, stag_tol, k=k,
                           gtol_relative=gtol_relative,
                           lbfgs_compact=lbfgs_compact)
            go = bool((c.grad_norm > cur_gtol) & ~c.stagnated)

    vio_new = entry_merge(dp, c.v_ew, c.v_ex, c.obj)
    y_head = -torch.minimum(dp.lam_ub, lam - sigma * vio_new[: dp.m])
    y_full = torch.cat([y_head, torch.ones(1, dtype=R.dtype,
                                           device=R.device)])
    ic = InnerCarry(R=c.R, G=c.G, y_full=y_full, vio_raw=vio_new,
                    L_val=c.L_val, grad_norm=c.grad_norm,
                    lbfgs=dataclasses.replace(c.lbfgs,
                                              head=int(c.lbfgs.head)),
                    steps=c.steps, stagnated=bool(c.stagnated))
    return ic, vio_norm_entry(dp, c.v_ew, c.v_ex, pscale)
