"""The sharded solve: each rank runs the single-device inner loop and
major-iteration state machine on its rank-local problem, with explicit
collectives.

Counterpart of the JAX package's ``parallel/shardmap.py`` (jax.shard_map
with hand-placed collectives). The communication pattern is the one the
math implies (SURVEY §5):

  * the factor R, the gradient, CX and the L-BFGS history are
    row-sharded; the SpMM reads its row support from the all-gathered
    factor or from a halo exchange (ops/spmm.support);
  * constraint values: per-rank partials summed (all_reduce);
  * scalar dots and norms of L-BFGS, the line search, the stagnation
    test and the Lanczos recurrences: summed;
  * the m-vectors (λ, violations, y) are replicated.

The ops switch into this mode through the ``spmd`` field of the
rank-local DeviceProblem (parallel/comm.Mesh), so the rank's program is
the single-device one plus the collectives. ``make_shardmap_inner`` and
``make_shardmap_major`` return that program: it takes and returns this
rank's rows of the row-sharded carries, as the body of the JAX
package's shard_map sees its shards, and the carries stay sharded
between calls. ``shard_carry`` / ``gather_carry`` convert a full
(n_pad-row) carry to this rank's rows and back, for a caller that holds
the whole factor (a check against one device, a checkpoint).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from ..compile import CompiledProblem
from ..ops.device import DeviceProblem, local_problem
from ..solver.inner import InnerCarry, inner_chunk
from ..solver.lbfgs import LBFGSState
from ..solver.major import major_chunk
from .comm import Mesh, all_gather_rows, local_rows, n_loc, row_offset


def halo_picked(cp: CompiledProblem, nd: int,
                halo: Optional[bool] = None) -> bool:
    """Whether the SpMM row support is a halo exchange: forced by
    ``halo`` True / False, else by volume. The halo wins when the
    per-rank off-shard support (nd − 1)·H is under 75 % of the
    all-gather's n_pad − n_loc rows (JAX package: shardmap.py:67-80)."""
    if halo is False:
        return False
    if cp.halo_send is None:
        if halo:
            raise ValueError(
                "halo=True but the compile carries no halo metadata "
                "(compile_problem(..., n_shards=nd))")
        return False
    if cp.halo_send.shape[0] != nd:
        if halo:
            raise ValueError(f"halo metadata built for "
                             f"{cp.halo_send.shape[0]} shards, mesh has {nd}")
        return False
    n_loc = cp.n_pad // nd
    return bool(halo) or (nd - 1) * cp.halo_H < 0.75 * (cp.n_pad - n_loc)


def shardmap_problem(cp: CompiledProblem, dtype, mesh: Mesh,
                     halo: Optional[bool] = None) -> DeviceProblem:
    """This rank's problem (ops/device.local_problem): the row-blocked and
    nnz-blocked arrays sharded, the constraint maps and m-vectors
    replicated. ``halo``: None picks halo exchange or all-gather for the
    SpMM row support by volume (``halo_picked``), True forces the halo,
    False the all-gather."""
    nd = mesh.size
    if cp.ell2_rows.shape[0] > 0 and cp.ell2_shards != nd:
        raise ValueError(
            f"tier-2 ELL rows were grouped for {cp.ell2_shards} shard(s) "
            f"but the mesh has {nd} ranks; recompile with "
            f"compile_problem(..., n_shards={nd})")
    for dim, name in [(cp.n_pad, "n_pad"), (cp.P_pad, "P_pad")]:
        if dim % nd != 0:
            raise ValueError(f"{name}={dim} not divisible by {nd} ranks")
    return local_problem(cp, dtype, mesh, halo=halo_picked(cp, nd, halo))


# ---- carries: this rank's rows of a full one, and back ----------------------

def shard_lbfgs(lb: LBFGSState, dp: DeviceProblem) -> LBFGSState:
    """This rank's rows of a full L-BFGS history."""
    o, n = row_offset(dp), n_loc(dp)
    return dataclasses.replace(lb, s_hist=lb.s_hist[:, o:o + n],
                               y_hist=lb.y_hist[:, o:o + n])


def gather_lbfgs(lb: LBFGSState, mesh: Mesh) -> LBFGSState:
    def g(h):   # (k, n_loc, r) -> (k, n_pad, r)
        return all_gather_rows(h.transpose(0, 1).contiguous(),
                               mesh).transpose(0, 1).contiguous()
    return dataclasses.replace(lb, s_hist=g(lb.s_hist), y_hist=g(lb.y_hist))


def shard_inner(ic: InnerCarry, dp: DeviceProblem) -> InnerCarry:
    """This rank's rows of a full InnerCarry."""
    rows = lambda x: None if x is None else local_rows(dp, x)
    return dataclasses.replace(ic, R=rows(ic.R), G=rows(ic.G), CX=rows(ic.CX),
                               lbfgs=shard_lbfgs(ic.lbfgs, dp))


def gather_inner(ic: InnerCarry, mesh: Mesh) -> InnerCarry:
    """The full InnerCarry from every rank's rows (a collective)."""
    full = lambda x: None if x is None else all_gather_rows(x, mesh)
    return dataclasses.replace(ic, R=full(ic.R), G=full(ic.G), CX=full(ic.CX),
                               lbfgs=gather_lbfgs(ic.lbfgs, mesh))


def shard_carry(carry, dp: DeviceProblem):
    """This rank's rows of a full MajorCarry."""
    return dataclasses.replace(carry, ic=shard_inner(carry.ic, dp))


def gather_carry(carry, mesh: Mesh):
    """The full MajorCarry from every rank's rows (a collective)."""
    return dataclasses.replace(carry, ic=gather_inner(carry.ic, mesh))


def make_shardmap_inner(mesh: Mesh, dp: DeviceProblem, *, k: int,
                        use_armijo: bool, gtol_relative: bool = True,
                        ptol_relative: bool = True,
                        lbfgs_compact: bool = True):
    """f(dp, R, G, y_full, vio_raw, L, grad_norm, lbfgs, lam, sigma,
    cur_gtol, stag_tol, max_steps) -> (carry, vio_norm), the inner chunk
    on the rank-local ``dp`` of ``mesh`` (JAX package: shardmap.py:180):
    R, G and the L-BFGS history are this rank's rows, in and out."""
    _check_mesh(mesh, dp)
    return functools.partial(
        inner_chunk, k=k, use_armijo=use_armijo,
        gtol_relative=gtol_relative, ptol_relative=ptol_relative,
        lbfgs_compact=lbfgs_compact)


def make_shardmap_major(mesh: Mesh, dp: DeviceProblem, *, k: int,
                        use_armijo: bool, q_max: int,
                        gtol_relative: bool = True,
                        ptol_relative: bool = True,
                        objtol_relative: bool = True,
                        highprecision: bool = False,
                        lbfgs_compact: bool = True,
                        dual_safeguard: bool = True,
                        blk_b: int = 0, blk_kmax: int = 0,
                        blk_margin_frac: float = 0.25,
                        blk_k_min: int = 4):
    """f(dp, carry, budget, major_budget, base_iter, stag_tol, ptol_final,
    gtol_final, objtol, sigmafac, trace_bound, rankupd_tol) ->
    (carry, vio_norm): the fused outer driver's state machine (inner
    loop, Lanczos bound with row-sharded Krylov vectors, dual ascent,
    σ and tolerance schedule) on the rank-local ``dp`` of ``mesh`` (JAX
    package: shardmap.py:232), the carry's R, G, CX and L-BFGS history
    this rank's rows, in and out; further keywords of
    solver/major.major_chunk (``entry_graphs``, ``inner_graphs``) pass
    through the call."""
    _check_mesh(mesh, dp)
    return functools.partial(
        major_chunk, k=k, use_armijo=use_armijo,
        gtol_relative=gtol_relative, ptol_relative=ptol_relative,
        objtol_relative=objtol_relative, q_max=q_max,
        highprecision=highprecision, lbfgs_compact=lbfgs_compact,
        dual_safeguard=dual_safeguard, blk_b=blk_b, blk_kmax=blk_kmax,
        blk_margin_frac=blk_margin_frac, blk_k_min=blk_k_min)


def _check_mesh(mesh: Mesh, dp: DeviceProblem):
    if dp.spmd is not mesh:
        raise ValueError("the problem is not this mesh's rank-local problem "
                         "(parallel.shardmap.shardmap_problem)")


def engine_suffix(dp: DeviceProblem) -> str:
    """The result's engine suffix: ``+spmd`` with the all-gathered row
    support, ``+spmd-halo`` with the halo exchange (the JAX package's
    ``+shard_map`` / ``+shard_map-halo``)."""
    return "+spmd-halo" if dp.halo_send is not None else "+spmd"


def n_shards_pad(nd: int) -> int:
    """Row and nnz padding of a compile for ``nd`` ranks: lcm(128, nd)."""
    return int(np.lcm(128, nd))
