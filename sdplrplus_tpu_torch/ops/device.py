"""DeviceProblem: the compiled problem as a dataclass of torch tensors.

Counterpart of the JAX package's ``ops/device.py``. Array fields are
tensors on one explicit ``device``; dimensions and layout metadata are
plain Python values. The field names and meanings are those of the JAX
``DeviceProblem``, so state carries across (``convert.py``).

A sharded solve gives each rank its own DeviceProblem
(``local_problem``): the row-blocked arrays hold this rank's rows, the
nnz arrays its block of the pattern, the rest is replicated, and
``spmd`` names the mesh (parallel/comm.py), as the JAX package's
``spmd_axis`` names its mesh axis. Dimensions stay global.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..compile import CompiledProblem


@dataclasses.dataclass(frozen=True)
class DeviceLowRank:
    B: torch.Tensor  # (n_pad, s)
    d: torch.Tensor  # (s,)
    gid: int = 0


# array fields, float-valued and int-valued (the order of the JAX dataclass)
FLOAT_FIELDS = (
    "c_val_one", "c_val_two", "con_val_two", "wide_val_two", "pos_val",
    "cell_val", "cell2_val", "diag_w", "b", "lam_ub", "vio_lb", "C_dense",
    "ew_c2", "ew_v1", "ew_h", "ew_C", "entry_cpen", "entry_csgn",
    "extra_wide_w", "wide_diag_w", "ls_cw", "ls_slope_pos", "ls_slope_neg",
    "ls_v_pos", "ls_v_neg",
)
INT_FIELDS = (
    "agg_rows", "agg_cols", "con_pos", "con_rows", "con_cols", "pos_cid",
    "diag_cid", "ell_cols", "ell_tri", "ell2_rows", "ell2_cols", "ell2_tri",
    "entry_gids", "entry_rows", "entry_cols", "ls_gid_pos", "ls_gid_neg",
)
STATIC_FIELDS = (
    "n", "m", "n_pad", "P_pad", "ell_width", "con_width", "pos_width",
    "diag_width", "all_cons_diagonal", "wide_gids", "extra_gids",
    "has_ell2", "ell2_width", "ell2_shards", "has_inequalities", "normC",
    "normb", "diag_identity", "ls_eligible", "ls_wide_gid",
    "entry_trace_cert", "trC_n", "entry_mix_c",
)
_T = Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DeviceProblem:
    # -- tensors -------------------------------------------------------------
    agg_rows: torch.Tensor
    agg_cols: torch.Tensor
    c_val_one: torch.Tensor
    c_val_two: torch.Tensor
    con_pos: torch.Tensor
    con_rows: torch.Tensor
    con_cols: torch.Tensor
    con_val_two: torch.Tensor
    wide_val_two: torch.Tensor
    pos_cid: torch.Tensor
    pos_val: torch.Tensor
    cell_val: torch.Tensor
    cell2_val: torch.Tensor
    diag_cid: torch.Tensor
    diag_w: torch.Tensor
    ell_cols: torch.Tensor
    ell_tri: torch.Tensor
    ell2_rows: torch.Tensor
    ell2_cols: torch.Tensor
    ell2_tri: torch.Tensor
    b: torch.Tensor
    lam_ub: torch.Tensor
    vio_lb: torch.Tensor
    lowrank: Tuple[DeviceLowRank, ...]
    C_dense: _T = None            # (n_pad, n_pad) dense C (dense mode)
    entry_gids: _T = None         # entrywise mode (ops/entrymask.py)
    entry_rows: _T = None
    entry_cols: _T = None
    ew_c2: _T = None
    ew_v1: _T = None
    ew_h: _T = None
    ew_C: _T = None
    entry_cpen: _T = None
    entry_csgn: _T = None
    extra_wide_w: _T = None
    wide_diag_w: _T = None        # (n_wide, n_pad)
    ls_cw: _T = None              # least-squares dual structure
    ls_slope_pos: _T = None
    ls_slope_neg: _T = None
    ls_gid_pos: _T = None
    ls_gid_neg: _T = None
    ls_v_pos: _T = None
    ls_v_neg: _T = None
    # the ELL SpMM's one row gather: tier-1 column ids, then tier-2's
    # (n_pad·W + R2·W2,), built once with the problem (ops/spmm.py)
    ell_ids: _T = None
    # the general forward operator's one row gather: the aggregate
    # pattern's rows, then its columns (2·P_pad,) (ops/forward.py)
    uv_ids: _T = None
    # halo-exchange SpMM (ops/spmm.support): this rank's send row lists
    # (nd-1, H), local row ids; set only when the halo layout is in use
    halo_send: _T = None

    # -- static metadata -----------------------------------------------------
    n: int = 0
    m: int = 0
    n_pad: int = 0
    P_pad: int = 0
    ell_width: int = 0
    con_width: int = 0
    pos_width: int = 0
    diag_width: int = 0
    all_cons_diagonal: bool = False
    wide_gids: tuple = ()
    extra_gids: tuple = ()
    has_ell2: bool = False
    ell2_width: int = 0
    ell2_shards: int = 1
    has_inequalities: bool = False
    normC: float = 1.0
    normb: float = 1.0
    diag_identity: bool = False
    ls_eligible: bool = False
    ls_wide_gid: int = -1
    entry_trace_cert: bool = False
    trC_n: float = 0.0
    entry_mix_c: float = 0.0
    # the mesh of a rank-local problem (parallel/comm.Mesh); None on one
    # device, where every collective hook is the identity
    spmd: Any = None

    @property
    def dtype(self) -> torch.dtype:
        return self.b.dtype

    @property
    def device(self) -> torch.device:
        return self.b.device


def fast_diag_eligible(dp) -> bool:
    """Whether the fast-diagonal single-SpMM inner path applies: every
    sparse-constraint entry on the diagonal, no dense or entrywise mode,
    no external model (adapter.CustomModel)."""
    return bool(
        getattr(dp, "all_cons_diagonal", False)
        and getattr(dp, "C_dense", None) is None
        and getattr(dp, "ew_c2", None) is None
        and getattr(dp, "fn_apply_S", None) is None
    )


def _diag_identity(cp: CompiledProblem) -> bool:
    """True when constraint i is exactly X_ii (weight 1, bijection with the
    first m rows) — MaxCut/CutNorm-shaped. Enables the closed-form
    least-squares dual estimate and the projected feasible objective."""
    n, m = cp.n, cp.m
    if not cp.all_cons_diagonal or cp.wide_gids or cp.diag_width != 1:
        return False
    if m != n or any(t.gid != m for t in cp.lowrank):
        return False
    cid = np.asarray(cp.diag_cid)[:n, 0]
    w = np.asarray(cp.diag_w)[:n, 0]
    return bool((cid == np.arange(n)).all() and (w == 1.0).all())


def _tensor(x, dtype, device):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def device_problem(arrays: dict, lowrank, statics: dict, dtype,
                   device) -> DeviceProblem:
    """Build a DeviceProblem from numpy arrays by field name (float fields
    cast to ``dtype``, index fields to int64; None stays None), with the
    SpMM's concatenated column ids ``ell_ids`` and the general forward
    operator's ``uv_ids``."""
    kw = {}
    for f in FLOAT_FIELDS:
        v = arrays.get(f)
        kw[f] = None if v is None else _tensor(v, dtype, device)
    for f in INT_FIELDS:
        v = arrays.get(f)
        kw[f] = None if v is None else _tensor(v, torch.int64, device)
    lr = tuple(
        DeviceLowRank(B=_tensor(B, dtype, device), d=_tensor(d, dtype, device),
                      gid=int(g))
        for B, d, g in lowrank
    )
    if kw["ell_cols"] is not None:
        tiers = [kw["ell_cols"].reshape(-1)]
        if kw["ell2_cols"] is not None:
            tiers.append(kw["ell2_cols"].reshape(-1))
        kw["ell_ids"] = torch.cat(tiers)
    if kw["agg_rows"] is not None:
        kw["uv_ids"] = torch.cat([kw["agg_rows"], kw["agg_cols"]])
    return DeviceProblem(lowrank=lr, **kw, **statics)


def _statics(cp: CompiledProblem) -> dict:
    return dict(
        n=cp.n, m=cp.m, n_pad=cp.n_pad, P_pad=cp.P_pad,
        ell_width=cp.ell_width, con_width=cp.con_width,
        pos_width=cp.pos_width, diag_width=cp.diag_width,
        all_cons_diagonal=bool(cp.all_cons_diagonal),
        wide_gids=tuple(int(g) for g in cp.wide_gids),
        extra_gids=tuple(int(g) for g in cp.extra_gids),
        has_ell2=cp.ell2_rows.shape[0] > 0, ell2_width=cp.ell2_width,
        ell2_shards=cp.ell2_shards,
        has_inequalities=bool(cp.has_inequalities),
        normC=float(cp.normC), normb=float(cp.normb),
        diag_identity=_diag_identity(cp),
        ls_eligible=bool(cp.ls_eligible), ls_wide_gid=int(cp.ls_wide_gid),
        entry_trace_cert=bool(cp.entry_trace_cert), trC_n=float(cp.trC_n),
        entry_mix_c=float(cp.entry_mix_c),
    )


def _arrays(cp: CompiledProblem) -> dict:
    arrays = {f: getattr(cp, f, None) for f in FLOAT_FIELDS + INT_FIELDS}
    if arrays["wide_diag_w"] is None:
        arrays["wide_diag_w"] = np.zeros((0, cp.n_pad))
    return arrays


def to_device(cp: CompiledProblem, dtype, device="cpu") -> DeviceProblem:
    """Push a CompiledProblem to ``device`` in ``dtype`` (lam_ub / vio_lb
    carry ±inf, representable in both float types)."""
    lowrank = [(t.B, t.d, t.gid) for t in cp.lowrank]
    return device_problem(_arrays(cp), lowrank, _statics(cp), dtype,
                          torch.device(device))


# The JAX package's PartitionSpecs (parallel/shardmap.py:99-177), by field:
# row-blocked (first axis over the n_pad rows, or over tier 2's per-shard
# groups), column-blocked (second axis over the rows) and nnz-blocked
# (over the aggregate pattern); every other array is replicated.
ROW_FIELDS = (
    "cell_val", "cell2_val", "diag_cid", "diag_w", "ell_cols", "ell_tri",
    "ell2_rows", "ell2_cols", "ell2_tri", "C_dense", "ew_c2", "ew_v1",
    "ew_h", "ew_C",
)
COL_FIELDS = ("wide_val_two", "extra_wide_w", "wide_diag_w")
NNZ_FIELDS = ("agg_rows", "agg_cols", "c_val_two")


def _block(x: np.ndarray, axis: int, rank: int, size: int) -> np.ndarray:
    n = x.shape[axis] // size
    return np.take(x, np.arange(rank * n, (rank + 1) * n), axis=axis)


def local_problem(cp: CompiledProblem, dtype, mesh,
                  halo: bool = False) -> DeviceProblem:
    """This rank's DeviceProblem of a compile made with
    ``n_shards = mesh.size``: its block of every row-, column- and
    nnz-blocked array, the replicated rest, ``spmd`` = mesh. With
    ``halo`` the ELL columns are the compile's remapped ones, which
    address [X_local; halo] (ops/spmm.support), and ``halo_send`` holds
    this rank's send lists; ``ell_ids`` is built from the local columns
    either way, ``uv_ids`` from the local pattern block."""
    nd, rank = mesh.size, mesh.rank
    arrays = _arrays(cp)
    if halo:
        arrays["ell_cols"] = cp.halo_ell_cols
        arrays["ell2_cols"] = cp.halo_ell2_cols
    for f, axis in ([(f, 0) for f in ROW_FIELDS + NNZ_FIELDS]
                    + [(f, 1) for f in COL_FIELDS]):
        v = arrays.get(f)
        if v is not None and np.asarray(v).ndim > axis:
            arrays[f] = _block(np.asarray(v), axis, rank, nd)
    lowrank = [(_block(np.asarray(t.B), 0, rank, nd), t.d, t.gid)
               for t in cp.lowrank]
    dp = device_problem(arrays, lowrank, _statics(cp), dtype, mesh.device)
    hs = None
    if halo:
        hs = _tensor(cp.halo_send[rank], torch.int64, mesh.device)
    return dataclasses.replace(dp, halo_send=hs, spmd=mesh)
