"""DeviceProblem: the compiled problem as a dataclass of torch tensors.

Counterpart of the JAX package's ``ops/device.py``. Array fields are
tensors on one explicit ``device``; dimensions and layout metadata are
plain Python values. The field names and meanings are those of the JAX
``DeviceProblem``, so state carries across (``convert.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    entry_gids: _T = None         # entrywise mode (a later slice)
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

    @property
    def dtype(self) -> torch.dtype:
        return self.b.dtype

    @property
    def device(self) -> torch.device:
        return self.b.device


def fast_diag_eligible(dp) -> bool:
    """Whether the fast-diagonal single-SpMM inner path applies: every
    sparse-constraint entry on the diagonal, no dense or entrywise mode."""
    return bool(
        getattr(dp, "all_cons_diagonal", False)
        and getattr(dp, "C_dense", None) is None
        and getattr(dp, "ew_c2", None) is None
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
    SpMM's concatenated column ids ``ell_ids``."""
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
    return DeviceProblem(lowrank=lr, **kw, **statics)


def to_device(cp: CompiledProblem, dtype, device="cpu") -> DeviceProblem:
    """Push a CompiledProblem to ``device`` in ``dtype`` (lam_ub / vio_lb
    carry ±inf, representable in both float types)."""
    device = torch.device(device)
    arrays = {f: getattr(cp, f, None) for f in FLOAT_FIELDS + INT_FIELDS}
    if arrays["wide_diag_w"] is None:
        arrays["wide_diag_w"] = np.zeros((0, cp.n_pad))
    statics = dict(
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
    lowrank = [(t.B, t.d, t.gid) for t in cp.lowrank]
    return device_problem(arrays, lowrank, statics, dtype, device)
