"""The inner L-BFGS loop as one CUDA launch: K1 (equality problems, exact
quartic line search) and K2 (inequality families, Armijo backtracking).

Counterpart of the JAX package's ``ops/megakernel.py``, whose Pallas TPU
kernels ``_make_kernel`` (K1, launched by ``_call_kernel``) and
``_make_kernel_armijo`` (K2, launched by ``_call_kernel_armijo``) these
replace. The hand-written Hopper kernels are ``csrc/megakernel.cu`` and
``csrc/megakernel_armijo.cu`` (CUDA C++ for sm_90a, plain C interface,
loaded with ``ctypes``; built at first use by ``utils/build.py``). Their
design notes — one cooperative persistent grid per inner activation,
column slabs per block, every dot batched behind one grid-wide barrier
and summed in the same fixed order by every block — are at the top of
those files.

What bounds them: per iteration D·C is 2·rp·n_pad² FP32 FLOPs (25.7
MFLOP at n_pad = 896 and rp = 16, about 0.38 µs at 67 TFLOP/s), and C is
read once per launch. Latency sets their time instead: grid barriers,
the totals after each, and the L2 round trips of D·C. Both kernels take
the compact L-BFGS direction, whose dots ride the gradient's barrier, so
each pays 3 grid barriers per iteration whatever k, and both keep C's
column slab and the ring's slab in shared memory where they fit
(``k1_smem_plan``, ``k2_smem_plan``). Their shared device code (the
reductions, the D·C register-tile product, the compact k×k solves, the
grid plan) is ``csrc/megakernel_common.cuh``. Both return the ring's
Grams SᵀY and YᵀY in ``LBFGSState``.

Layout and contract are those of the JAX kernels: the factor, gradient
and ring live transposed and rank-padded, (rp, n_pad) and (k·rp, n_pad),
so each column of the kernel's arrays is one row of R. ``mega_chunk``
keeps the ``mega_chunk_traced`` contract (megakernel.py:1184-1269, and
``mega_chunk_traced_armijo`` :1094-1181 for K2): R, the L-BFGS state and
the multipliers in, (InnerCarry, vio_norm) out. On a CUDA tensor it
launches the kernel (and counts the launch in ``K1.launches`` or
``K2.launches``); on a CPU tensor it runs the plain version
(``mega_chunk_plain``, ``mega_chunk_armijo_plain``), the kernel's loop
written step by step in torch. It never falls back from one to the
other.

Eligibility is structural plus this layout's limits: n_pad ≤ 2048 and a
multiple of 64, padded rank rp ≤ 64, at most 16 ring slots, at most 4
low-rank equality terms with 8 columns in all. K1 takes dense-C equality
problems with one diagonal entry per constraint; K2 takes any problem
whose constraint entries all lie on the diagonal, with at most 4
channels per row, at most 2 wide constraints and one diagonal entry per
narrow constraint (C densified from the ELL layout). That covers n_pad
896 and 2048 up to the Barvinok–Pataki rank cap (41 at m = 800, 57 at
m = 1602, 64 at m = 2000). C then takes at most 16.8 MB (f32) or
33.6 MB (f64) of the 50 MB L2. K2 also needs its shared memory within a
block's 227 KB (``k2_smem_plan``: the slab arrays and the 2k ring slots
at rp × 16 each, plus C's slab where it fits), which leaves out float64
with 16 ring slots above rp 40. K1 reads the ring's slab from L2 where
it does not fit (``k1_smem_plan``), so every shape within the layout's
limits runs on K1. The kernels also check at launch that their grid is
co-resident.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..solver.linesearch import (
    ARMIJO_C, N_CAND, armijo_candidates, armijo_pick,
)
from ..utils.build import CudaLibrary
from .device import DeviceProblem

MAX_LR_TERMS = 4
MAX_LR_COLS = 8
MAX_N_PAD = 2048
MAX_RP = 64
MAX_K = 16
N_CHUNK = 64  # the kernels' n-axis granule (IC in csrc/megakernel_common.cuh)
MAX_DIAG_CHANNELS = 4   # K2: diagonal constraint channels per row
MAX_WIDE = 2            # K2: wide diagonal constraints
# K2's sufficient-decrease constant ARMIJO_C and its N_CAND = 51 candidate
# steps α_max·2⁻ᵗ, t = 0..50, are the torch line search's
# (solver/linesearch.py)
_PI = 3.141592653589793


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class MegaSpec:
    """Static layout/config of one kernel specialization."""

    n_pad: int
    rp: int                 # padded rank (multiple of 8)
    k: int                  # ring length (>= 1; use_hist gates its use)
    use_hist: bool          # False when numlbfgsvecs == 0
    gscale: float           # grad-norm divisor (normC if relative)
    lr_sizes: Tuple[int, ...]       # s of each low-rank term
    lr_is_obj: Tuple[bool, ...]     # True: the term belongs to the objective
    lr_gids: Tuple[int, ...] = ()   # global constraint ids (wrapper only)
    alpha_max: float = 1.0
    # K2 (inequality families): J diagonal constraint channels per row,
    # n_wide wide diagonal constraints, the sharp AL and Armijo
    # backtracking; armijo=False is K1
    armijo: bool = False
    J: int = 1
    n_wide: int = 0
    wide_gids: Tuple[int, ...] = ()   # their global ids (wrapper only)

    @property
    def n_lr(self):
        return len(self.lr_sizes)

    @property
    def lr_cons(self):
        return tuple(t for t in range(self.n_lr) if not self.lr_is_obj[t])

    @property
    def n_scal_out(self):
        """[L, obj, gnorm, steps, stagnated, α, head, ρ (k), low-rank
        violations, wide violations, SᵀY (k²), YᵀY (k²)]."""
        return self.o_gram + 2 * self.k * self.k

    @property
    def o_gram(self):
        """Offset of SᵀY in the scalar outputs (YᵀY follows)."""
        return 7 + self.k + max(len(self.lr_cons), 1) + self.n_wide


# --------------------------------------------------------------------------
# eligibility and data preparation
# --------------------------------------------------------------------------

def _layout_ok(dp: DeviceProblem, r: int, k: int) -> bool:
    """This layout's limits (see the module docstring)."""
    return (
        dp.n_pad <= MAX_N_PAD and dp.n_pad % N_CHUNK == 0
        and _round_up(max(r, 1), 8) <= MAX_RP
        and max(k, 1) <= MAX_K
        and sum(int(t.B.shape[1]) for t in dp.lowrank) <= MAX_LR_COLS
    )


# The kernels' shared memory (smem_elems in csrc/megakernel.cu and
# csrc/megakernel_armijo.cu, whose layouts these mirror): C's column slab
# (8 or 16 rows) where it fits, the slab arrays (Rt, CRt, CDt, D and two
# G, each (rp, 16)), the 2k ring slots at (rp, 16) each (always for K2,
# where they fit for K1), the column rows and small scalars. Eligibility
# assumes the H100's 132 SMs for the slab width S = ceil(n_pad / 132); the
# kernels' plans use the card's count and the wrapper checks that both
# agree.
SMEM_MAX = 232448
H100_SMS = 132
_K1_N_LS = 2 + 9
_K2_N_LS = 2 + 2 * MAX_WIDE + N_CAND


def _c_rows(n_pad: int, sms: int) -> int:
    return 8 if -(-n_pad // sms) <= 8 else 16


def _gram_npart(k: int) -> int:
    """Partial slots of the entry's Grams and of a gradient with a push."""
    return max(1 + 2 * k + 2 * k * k, 1 + 5 * k)


def k1_npart(rp: int, k: int, lrc: int) -> int:
    return max(_K1_N_LS + rp * lrc, _gram_npart(k))


def k2_npart(rp: int, k: int, lrc: int) -> int:
    return max(_K2_N_LS + rp * lrc, _gram_npart(k))


def k1_smem_bytes(n_pad: int, rp: int, k: int, lrc: int, itemsize: int,
                  c_res: bool, ring_res: bool, sms: int = H100_SMS) -> int:
    elems = ((_c_rows(n_pad, sms) * n_pad if c_res else 0)
             + (6 + (2 * k if ring_res else 0)) * rp * 16 + 6 * 16
             + 8 * 32 + k1_npart(rp, k, lrc) + rp * lrc
             + 2 * 16 * MAX_LR_COLS + k + 2 * k * k + 2 * k + 1
             + 2 * MAX_LR_TERMS)
    return elems * itemsize


def k2_smem_bytes(n_pad: int, rp: int, k: int, lrc: int, itemsize: int,
                  resident: bool, sms: int = H100_SMS) -> int:
    elems = ((_c_rows(n_pad, sms) * n_pad if resident else 0)
             + (6 + 2 * k) * rp * 16
             + 5 * MAX_DIAG_CHANNELS * 16 + (3 + MAX_WIDE) * 16 + N_CAND
             + 8 * 32 + k2_npart(rp, k, lrc) + rp * lrc
             + 2 * 16 * MAX_LR_COLS + k + 2 * k * k + 2 * k + 2
             + N_CAND + 2 * MAX_LR_TERMS + 2)
    return elems * itemsize


def k1_smem_plan(n_pad: int, rp: int, k: int, lrc: int, itemsize: int,
                 sms: int = H100_SMS):
    """(bytes, C resident, ring resident) of K1's shared memory: C's slab
    and the ring's slab where both fit, else C's alone, else the ring's
    alone, else neither (the product then reads C from L2, the direction
    and the Grams the ring). None when even the last exceeds a block's
    227 KB, which no shape within the layout's limits does."""
    for c_res, ring_res in ((True, True), (True, False), (False, True),
                            (False, False)):
        b = k1_smem_bytes(n_pad, rp, k, lrc, itemsize, c_res, ring_res, sms)
        if b <= SMEM_MAX:
            return b, c_res, ring_res
    return None


def k2_smem_plan(n_pad: int, rp: int, k: int, lrc: int, itemsize: int,
                 sms: int = H100_SMS):
    """(bytes, C resident) of K2's shared memory, or None when even
    without C's slab it exceeds a block's 227 KB."""
    with_c = k2_smem_bytes(n_pad, rp, k, lrc, itemsize, True, sms)
    if with_c <= SMEM_MAX:
        return with_c, True
    without = k2_smem_bytes(n_pad, rp, k, lrc, itemsize, False, sms)
    return (without, False) if without <= SMEM_MAX else None


def _entry_counts(dp: DeviceProblem, cid: np.ndarray) -> np.ndarray:
    """How often each constraint id appears among the diagonal slots."""
    return np.bincount(cid[cid < dp.m], minlength=max(dp.m, 1))


def megakernel_eligible(dp: DeviceProblem, r: int, k: int, use_armijo: bool,
                        dtype) -> bool:
    """True when a megakernel can run this problem (megakernel.py:870-908):
    K2 for inequality / multi-channel / wide-constraint problems (every
    constraint entry diagonal, at most MAX_DIAG_CHANNELS channels per row,
    at most MAX_WIDE wide constraints, one diagonal entry per narrow
    constraint), K1 otherwise (dense C, one diagonal entry per
    constraint); both with at most MAX_LR_TERMS low-rank equality terms
    and within the layout's limits. Never on a rank-local problem
    (``dp.spmd``): the kernels hold the whole factor (JAX package:
    ops/megakernel.py:856)."""
    if dtype not in (torch.float32, torch.float64):
        return False
    if getattr(dp, "fn_apply_S", None) is not None:  # external model
        return False
    if getattr(dp, "spmd", None) is not None:
        return False
    if dp.ew_c2 is not None or len(dp.lowrank) > MAX_LR_TERMS:
        return False
    lam_ub = dp.lam_ub.detach().cpu().numpy()
    if any(t.gid < dp.m and np.isfinite(lam_ub[t.gid]) for t in dp.lowrank):
        return False
    if not _layout_ok(dp, r, k):
        return False
    lr_gids = {t.gid for t in dp.lowrank}
    cid = dp.diag_cid.detach().cpu().numpy()
    if use_armijo or dp.has_inequalities or dp.wide_gids:
        # the per-slot channel violation w·rv − b is that constraint's
        # value only under the one-entry bijection
        if not (dp.all_cons_diagonal
                and 1 <= dp.diag_width <= MAX_DIAG_CHANNELS
                and len(dp.wide_gids) <= MAX_WIDE):
            return False
        lrc = sum(int(t.B.shape[1]) for t in dp.lowrank)
        if k2_smem_plan(dp.n_pad, _round_up(max(r, 1), 8), max(k, 1), lrc,
                        torch.finfo(dtype).bits // 8) is None:
            return False
        counts = _entry_counts(dp, cid.ravel())
        skip = set(dp.wide_gids) | lr_gids
        return all(counts[g] == 1 for g in range(dp.m) if g not in skip)
    if dp.C_dense is None or dp.diag_width != 1:
        return False
    lrc = sum(int(t.B.shape[1]) for t in dp.lowrank)
    if k1_smem_plan(dp.n_pad, _round_up(max(r, 1), 8), max(k, 1), lrc,
                    torch.finfo(dtype).bits // 8) is None:
        return False
    # row<->constraint bijection: every non-lowrank constraint id appears
    # exactly once on the diagonal
    counts = _entry_counts(dp, cid[:, 0])
    return all(counts[g] == (0 if g in lr_gids else 1) for g in range(dp.m))


@dataclasses.dataclass(frozen=True)
class MegaData:
    """Problem tensors K1 needs, on the solve's device."""

    C: torch.Tensor          # (n_pad, n_pad) dense cost
    cid_dev: torch.Tensor    # (n_pad,) row -> constraint id (m = none)
    w_row: torch.Tensor      # (1, n_pad) diagonal weights
    b_row: torch.Tensor      # (1, n_pad) row-ordered rhs
    b_lr: torch.Tensor       # (n_lr_cons,) rhs of low-rank constraints
    lam_ub: torch.Tensor     # (m,)
    vio_lb: torch.Tensor     # (m,)
    lr_B: torch.Tensor       # (n_pad, Σs) the terms' B side by side
    lr_Bdt: torch.Tensor     # (Σs, n_pad) d-scaled Bᵀ
    lr_d: torch.Tensor       # (Σs,)


@dataclasses.dataclass(frozen=True)
class MegaDataA:
    """Problem tensors K2 needs, on the solve's device."""

    C: torch.Tensor          # (n_pad, n_pad) dense cost (densified here)
    cid_ch: torch.Tensor     # (J, n_pad) channel -> constraint id (m = none)
    W_ch: torch.Tensor       # (J, n_pad) channel weights
    B_ch: torch.Tensor       # (J, n_pad) channel rhs
    UB_ch: torch.Tensor      # (J, n_pad) channel λ upper bounds
    WW: torch.Tensor         # (max(n_wide, 1), n_pad) wide weight rows
    b_wide: torch.Tensor     # (n_wide,)
    ub_wide: torch.Tensor    # (n_wide,)
    b_lr: torch.Tensor       # (n_lr_cons,)
    lam_ub: torch.Tensor     # (m,)
    vio_lb: torch.Tensor     # (m,)
    lr_B: torch.Tensor       # (n_pad, Σs)
    lr_Bdt: torch.Tensor     # (Σs, n_pad)
    lr_d: torch.Tensor       # (Σs,)


def _lowrank_prep(dp: DeviceProblem, k: int, gtol_relative: bool,
                  ptol_relative: bool):
    """The spec ingredients and low-rank tensors both kernels share:
    (meta, lr_B, lr_Bdt, lr_d, b_lr)."""
    dtype, dev = dp.dtype, dp.device
    m, n_pad = dp.m, dp.n_pad
    b_np = dp.b.detach().cpu().numpy().astype(np.float64)
    lr_terms = list(dp.lowrank)
    t_ = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    if lr_terms:
        lr_B = torch.cat([t.B for t in lr_terms], dim=1)
        lr_Bdt = torch.cat([t.d[:, None] * t.B.T for t in lr_terms], dim=0)
        lr_d = torch.cat([t.d for t in lr_terms])
    else:
        lr_B, lr_Bdt, lr_d = t_(np.zeros((n_pad, 0))), \
            t_(np.zeros((0, n_pad))), t_(np.zeros(0))
    meta = dict(
        n_pad=n_pad, m=m, kk=max(k, 1), use_hist=k > 0,
        gscale=float(dp.normC if gtol_relative else 1.0),
        pscale=float(dp.normb if ptol_relative else 1.0),
        lr_sizes=tuple(int(t.B.shape[1]) for t in lr_terms),
        lr_is_obj=tuple(t.gid == m for t in lr_terms),
        lr_gids=tuple(t.gid for t in lr_terms),
    )
    b_lr = t_([b_np[t.gid] for t in lr_terms if t.gid != m])
    return (meta, lr_B.contiguous(), lr_Bdt.contiguous(), lr_d.contiguous(),
            b_lr)


def prepare_mega_data(dp: DeviceProblem, *, k: int, gtol_relative: bool,
                      ptol_relative: bool):
    """Host-side index prep. Returns (meta, MegaData), or (meta,
    MegaDataA) for K2's families; meta carries the spec ingredients."""
    if dp.has_inequalities or dp.wide_gids or dp.diag_width != 1 \
            or dp.C_dense is None:
        return prepare_mega_data_armijo(dp, k=k, gtol_relative=gtol_relative,
                                        ptol_relative=ptol_relative)
    dtype, dev = dp.dtype, dp.device
    m, n_pad = dp.m, dp.n_pad
    cid = dp.diag_cid[:, 0].detach().cpu().numpy().astype(np.int64)
    w_np = dp.diag_w[:, 0].detach().cpu().numpy()
    valid = cid < m
    b_np = dp.b.detach().cpu().numpy().astype(np.float64)
    b_row_np = (np.where(valid, b_np[np.minimum(cid, max(m - 1, 0))], 0.0)
                if m else np.zeros(n_pad))
    meta, lr_B, lr_Bdt, lr_d, b_lr = _lowrank_prep(dp, k, gtol_relative,
                                                   ptol_relative)
    t_ = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    data = MegaData(
        C=dp.C_dense.contiguous(),
        cid_dev=torch.as_tensor(np.where(valid, cid, m), device=dev),
        w_row=t_(w_np).reshape(1, n_pad),
        b_row=t_(b_row_np).reshape(1, n_pad),
        b_lr=b_lr, lam_ub=dp.lam_ub, vio_lb=dp.vio_lb,
        lr_B=lr_B, lr_Bdt=lr_Bdt, lr_d=lr_d,
    )
    return meta, data


def _densify_C(dp: DeviceProblem) -> np.ndarray:
    """The sparse part of C as a dense (n_pad, n_pad) array, from the
    compiled two-tier ELL layout (megakernel.py:943-958; padding slots
    carry value 0, so blanket adds are safe)."""
    n_pad = dp.n_pad
    C = np.zeros((n_pad, n_pad))
    cols = dp.ell_cols.detach().cpu().numpy()
    vals = dp.cell_val.detach().cpu().numpy().astype(np.float64)
    rows = np.repeat(np.arange(n_pad), cols.shape[1])
    np.add.at(C, (rows, cols.reshape(-1)), vals.reshape(-1))
    if dp.has_ell2:
        r2 = dp.ell2_rows.detach().cpu().numpy()
        c2 = dp.ell2_cols.detach().cpu().numpy()
        v2 = dp.cell2_val.detach().cpu().numpy().astype(np.float64)
        np.add.at(C, (np.repeat(r2, c2.shape[1]), c2.reshape(-1)),
                  v2.reshape(-1))
    return C


def prepare_mega_data_armijo(dp: DeviceProblem, *, k: int,
                             gtol_relative: bool, ptol_relative: bool):
    """Host-side prep for K2 (megakernel.py:961-1024): the diagonal
    constraint slots split into per-row channels (wide constraints moved
    to their dense weight rows), C densified from the ELL layout, the
    per-channel rhs and λ upper-bound rows. Returns (meta, MegaDataA)."""
    dtype, dev = dp.dtype, dp.device
    m, n_pad = dp.m, dp.n_pad
    J = max(dp.diag_width, 1)
    cid = dp.diag_cid.detach().cpu().numpy().astype(np.int64)   # (n_pad, J)
    w = dp.diag_w.detach().cpu().numpy().astype(np.float64)
    wide_gids = list(dp.wide_gids)
    is_wide = np.isin(cid, wide_gids)
    cid_ch = np.where(is_wide, m, cid)
    w_ch = np.where(is_wide, 0.0, w)
    b_np = dp.b.detach().cpu().numpy().astype(np.float64)
    ub_np = dp.lam_ub.detach().cpu().numpy().astype(np.float64)
    b_ext = np.concatenate([b_np, [0.0]])
    ub_ext = np.concatenate([ub_np, [np.inf]])
    WW = dp.wide_diag_w.detach().cpu().numpy().astype(np.float64)
    if WW.shape[0] == 0:
        WW = np.zeros((1, n_pad))
    meta, lr_B, lr_Bdt, lr_d, b_lr = _lowrank_prep(dp, k, gtol_relative,
                                                   ptol_relative)
    meta.update(armijo=True, J=J, n_wide=len(wide_gids),
                wide_gids=tuple(int(g) for g in wide_gids))
    t_ = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)
    C = dp.C_dense if dp.C_dense is not None else t_(_densify_C(dp))
    data = MegaDataA(
        C=C.contiguous(),
        cid_ch=torch.as_tensor(np.ascontiguousarray(cid_ch.T), device=dev),
        W_ch=t_(w_ch.T), B_ch=t_(b_ext[cid_ch].T), UB_ch=t_(ub_ext[cid_ch].T),
        WW=t_(WW), b_wide=t_(b_np[wide_gids]), ub_wide=t_(ub_np[wide_gids]),
        b_lr=b_lr, lam_ub=dp.lam_ub, vio_lb=dp.vio_lb,
        lr_B=lr_B, lr_Bdt=lr_Bdt, lr_d=lr_d,
    )
    return meta, data


def mega_spec_for(meta: dict, r: int) -> MegaSpec:
    return MegaSpec(
        n_pad=meta["n_pad"], rp=_round_up(max(r, 1), 8), k=meta["kk"],
        use_hist=meta["use_hist"], gscale=meta["gscale"],
        lr_sizes=meta["lr_sizes"], lr_is_obj=meta["lr_is_obj"],
        lr_gids=meta["lr_gids"], armijo=bool(meta.get("armijo", False)),
        J=int(meta.get("J", 1)), n_wide=int(meta.get("n_wide", 0)),
        wide_gids=tuple(meta.get("wide_gids", ())),
    )


# --------------------------------------------------------------------------
# the plain version: the kernel's loop step by step in torch
# --------------------------------------------------------------------------

def _cubic_roots(a, b, c, d, eps):
    """Real roots of a x³ + b x² + c x + d as (roots[3], valid[3]) — the
    NaN-free form of the kernel (ops/cubic.py's algebra). 0-dim tensors."""
    one = torch.ones_like(a)
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          torch.maximum(c.abs(), d.abs())) + eps
    is_cubic = a.abs() > eps * scale
    is_quad = b.abs() > eps * scale
    lin_root = -d / torch.where(c.abs() > 0, c, one)
    b_safe = torch.where(is_quad, b, one)
    disc_q = c * c - 4.0 * b_safe * d
    sq = torch.sqrt(torch.clamp(disc_q, min=0.0))
    quad1 = (-c + sq) / (2.0 * b_safe)
    quad2 = (-c - sq) / (2.0 * b_safe)
    qvalid = disc_q >= 0.0
    a_safe = torch.where(is_cubic, a, one)
    bb, cc, dd = b / a_safe, c / a_safe, d / a_safe
    p = cc - bb * bb / 3.0
    q = 2.0 * bb * bb * bb / 27.0 - bb * cc / 3.0 + dd
    shift = -bb / 3.0
    q2, p3 = q / 2.0, p / 3.0
    disc = q2 * q2 + p3 * p3 * p3
    sdisc = torch.sqrt(torch.clamp(disc, min=0.0))
    single = _cbrt(-q / 2.0 + sdisc) + _cbrt(-q / 2.0 - sdisc) + shift
    pm = torch.clamp(p, max=-eps)
    rr = torch.sqrt(-pm / 3.0)
    cos_arg = torch.clamp(3.0 * q / (2.0 * pm * rr), -1.0, 1.0)
    phi = torch.arccos(cos_arg)
    t0 = 2.0 * rr * torch.cos(phi / 3.0) + shift
    t1 = 2.0 * rr * torch.cos((phi - 2.0 * _PI) / 3.0) + shift
    t2 = 2.0 * rr * torch.cos((phi - 4.0 * _PI) / 3.0) + shift
    one_real = disc > 0.0
    c0 = torch.where(one_real, single, t0)
    c1 = torch.where(one_real, single, t1)
    c2 = torch.where(one_real, single, t2)
    r0 = torch.where(is_cubic, c0, torch.where(is_quad, quad1, lin_root))
    r1 = torch.where(is_cubic, c1, quad2)
    v0 = is_cubic | ~is_quad
    v1 = torch.where(is_cubic, ~one_real, is_quad & qvalid)
    v2 = is_cubic & ~one_real
    return (r0, r1, c2), (v0, v1, v2)


def _cbrt(x):
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def minimize_quartic_kernel(e, d1, c1, b1, a1, alpha_max, eps):
    """argmin over [0, alpha_max] of e + d1 a + c1 a² + b1 a³ + a1 a⁴ as
    the kernel computes it: closed-form roots of the derivative cubic, one
    Newton polish each, clipped, compared with both endpoints (the first
    strictly smaller value wins). Matches ops/cubic.py minimize_quartic."""
    zero = torch.zeros_like(e)
    amax = torch.full_like(e, alpha_max)
    (r0, r1, r2), (v0, v1, v2) = _cubic_roots(4.0 * a1, 3.0 * b1, 2.0 * c1,
                                              d1, eps)

    def fval(x):
        return e + x * (d1 + x * (c1 + x * (b1 + x * a1)))

    def polish(x):
        fp = d1 + x * (2.0 * c1 + x * (3.0 * b1 + x * 4.0 * a1))
        fpp = 2.0 * c1 + x * (6.0 * b1 + x * 12.0 * a1)
        ok = fpp.abs() > eps
        return torch.where(ok, x - fp / torch.where(ok, fpp, torch.ones_like(fpp)), x)

    cands = [torch.minimum(torch.clamp(torch.where(v, polish(r), zero),
                                       min=0.0), amax)
             for r, v in ((r0, v0), (r1, v1), (r2, v2))] + [amax, zero]
    best_a, best_f = cands[0], fval(cands[0])
    for cand in cands[1:]:
        f = fval(cand)
        take = f < best_f
        best_a = torch.where(take, cand, best_a)
        best_f = torch.where(take, f, best_f)
    return best_a, best_f


def _lr_slices(spec: MegaSpec):
    off = np.concatenate([[0], np.cumsum(spec.lr_sizes)]).astype(int)
    return [slice(off[t], off[t + 1]) for t in range(spec.n_lr)]


def _compact_w_plain(k: int, head: int, rho, sty, yty, p):
    """The compact-form coefficients w (2k) with −H·g = −(g + [S Y]·w):
    u = R⁻¹Sᵀg, v = D·u + YᵀY·u − Yᵀg, w = [R⁻ᵀv; −u] on the Grams in age
    order (slot (head + 1 + a) % k for a = 0 oldest .. k − 1), empty slots
    (ρ = 0) masked with a unit diagonal — lbfgs._direction_compact's
    algebra, taking p = [Sᵀg; Yᵀg] and the Grams as the kernel has them."""
    perm = torch.as_tensor([(head + 1 + a) % k for a in range(k)],
                           device=p.device)
    empty = rho[perm] == 0.0
    live = ~(empty[:, None] | empty[None, :])
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    stp = torch.where(live, sty[perm][:, perm], zero)
    ytp = torch.where(live, yty[perm][:, perm], zero)
    Rp = torch.triu(stp) + torch.diag(empty.to(p.dtype))
    u = torch.linalg.solve_triangular(Rp, p[perm][:, None], upper=True)[:, 0]
    v = torch.diagonal(stp) * u + ytp @ u - p[k + perm]
    w1 = torch.linalg.solve_triangular(Rp.T, v[:, None], upper=False)[:, 0]
    w = torch.zeros(2 * k, dtype=p.dtype, device=p.device)
    w[perm] = w1
    w[k + perm] = -u
    return w


def _ring_views(spec: MegaSpec, s_ring, y_ring):
    """(k, rp·n_pad) views of the kernel-layout rings."""
    return s_ring.reshape(spec.k, -1), y_ring.reshape(spec.k, -1)


def _push_plain(head: int, k: int, S2, Y2, sty, yty, rho, s_new,
                y_new) -> int:
    """Push (s, y) into the ring's next slot j (the (k, ·) views S2, Y2,
    in place) and refresh row and column j of the Grams over the ring
    after the push; ρ_j = 1/(s_j·y_j). Returns j, the new head."""
    j = (head + 1) % k
    S2[j] = s_new.reshape(-1)
    Y2[j] = y_new.reshape(-1)
    sty[j, :] = Y2 @ S2[j]
    sty[:, j] = S2 @ Y2[j]
    yty[j, :] = Y2 @ Y2[j]
    yty[:, j] = yty[j, :]
    rho[j] = 1.0 / sty[j, j]
    return j


def mega_chunk_plain(spec: MegaSpec, scal, C, Rt_in, lam_row, w_row, b_row,
                     s_ring, y_ring, lr_B, lr_Bdt, lr_d):
    """K1's loop, step by step in torch, on the kernel's layout: the same
    inputs as the CUDA launch, and the same outputs (Rt, G, vio (1,
    n_pad), oscal with the ring's SᵀY and YᵀY). Like the kernel it
    updates the rings ``s_ring``/``y_ring`` (k·rp, n_pad) in place.

    The direction is the compact L-BFGS form on Grams built from the ring
    at entry and refreshed on every push (its row and column), with the
    descent test ⟨G, D⟩ = −(gᵀg + wᵀp) from scalars, as the kernel
    computes them (the Gram bookkeeping of ``mega_chunk_armijo_plain``).
    The scalar line search runs on the host in the working dtype;
    everything of size n runs on the tensors' device."""
    k = spec.k
    dtype, dev = Rt_in.dtype, Rt_in.device
    eps = torch.finfo(dtype).eps
    host = lambda x: x.detach().to("cpu")
    scal_h = host(scal)
    sigma = scal[0]
    cur_gtol = float(scal_h[1])
    stag_tol = scal_h[2]
    max_steps = int(scal_h[3])
    head = int(scal_h[4])
    rho = scal[5:5 + k].clone()
    n_lc = len(spec.lr_cons)
    lam_lc = scal[5 + k:5 + k + n_lc]
    b_lc = scal[5 + k + n_lc:5 + k + 2 * n_lc]
    lam, w, b = lam_row, w_row, b_row
    sl = _lr_slices(spec)
    cons_idx = {t: i for i, t in enumerate(spec.lr_cons)}

    def lr_tr(Qa, Qb, t):
        return torch.sum(Qa[:, sl[t]] * Qb[:, sl[t]] * lr_d[sl[t]])

    def state_of(Rt, CRt, Q):
        obj = torch.sum(Rt * CRt)
        for t in range(spec.n_lr):
            if spec.lr_is_obj[t]:
                obj = obj + lr_tr(Q, Q, t)
        vio = w * torch.sum(Rt * Rt, dim=0, keepdim=True) - b
        vio_lr = [lr_tr(Q, Q, t) - b_lc[i] for t, i in cons_idx.items()]
        return obj, vio, vio_lr

    def al_of(obj, vio, vio_lr):
        L = obj - torch.sum(lam * vio) + 0.5 * sigma * torch.sum(vio * vio)
        for i in range(n_lc):
            L = L - lam_lc[i] * vio_lr[i] + 0.5 * sigma * vio_lr[i] * vio_lr[i]
        return L

    def grad_of(Rt, CRt, Q, vio, vio_lr):
        y_row = -(lam - sigma * vio)
        G = 2.0 * (CRt + (w * y_row) * Rt)
        for t in range(spec.n_lr):
            if spec.lr_is_obj[t]:
                y_t = 1.0
            else:
                i = cons_idx[t]
                y_t = -(lam_lc[i] - sigma * vio_lr[i])
            G = G + 2.0 * y_t * (Q[:, sl[t]] @ lr_Bdt[sl[t]])
        return G

    Rt = Rt_in.clone()
    CRt = Rt @ C
    Q = Rt @ lr_B
    obj, vio, vio_lr = state_of(Rt, CRt, Q)
    L_val = al_of(obj, vio, vio_lr)
    G = grad_of(Rt, CRt, Q, vio, vio_lr)
    S2, Y2 = _ring_views(spec, s_ring, y_ring)
    sty, yty = S2 @ Y2.T, Y2 @ Y2.T
    gsq = torch.sum(G * G)
    p = torch.cat([S2 @ G.reshape(-1), Y2 @ G.reshape(-1)])
    gnorm = torch.sqrt(gsq) / spec.gscale
    steps, stag = 0, False
    alpha = torch.zeros((), dtype=dtype, device=dev)

    while float(gnorm) > cur_gtol and steps < max_steps and not stag:
        direction = -G
        if spec.use_hist:
            wc = _compact_w_plain(k, head, rho, sty, yty, p)
            descent = -(gsq + wc @ p)
            if not (math.isnan(float(descent)) or float(descent) >= 0.0):
                W2 = torch.cat([S2, Y2])
                direction = -(G.reshape(-1) + W2.T @ wc).reshape(G.shape)

        # line-search products
        CDt = direction @ C
        p1 = 2.0 * torch.sum(Rt * CDt)
        p2 = torch.sum(direction * CDt)
        q1 = 2.0 * w * torch.sum(Rt * direction, dim=0, keepdim=True)
        q2 = w * torch.sum(direction * direction, dim=0, keepdim=True)
        M4 = torch.cat([lam, vio, q1, q2], dim=0)
        Gm = M4 @ M4.T
        Qd = direction @ lr_B
        p1_lr = [2.0 * lr_tr(Q, Qd, t) for t in range(spec.n_lr)]
        p2_lr = [lr_tr(Qd, Qd, t) for t in range(spec.n_lr)]
        for t in range(spec.n_lr):
            if spec.lr_is_obj[t]:
                p1 = p1 + p1_lr[t]
                p2 = p2 + p2_lr[t]
        e = obj - Gm[0, 1] + 0.5 * sigma * Gm[1, 1]
        d1 = p1 - Gm[0, 2] + sigma * Gm[1, 2]
        c1 = p2 - Gm[0, 3] + sigma * Gm[1, 3] + 0.5 * sigma * Gm[2, 2]
        b1 = sigma * Gm[2, 3]
        a1 = 0.5 * sigma * Gm[3, 3]
        for t, i in cons_idx.items():
            lq1, lq2, lv = p1_lr[t], p2_lr[t], vio_lr[i]
            e = e - lam_lc[i] * lv + 0.5 * sigma * lv * lv
            d1 = d1 - lam_lc[i] * lq1 + sigma * lv * lq1
            c1 = c1 - lam_lc[i] * lq2 + sigma * lv * lq2 \
                + 0.5 * sigma * lq1 * lq1
            b1 = b1 + sigma * lq1 * lq2
            a1 = a1 + 0.5 * sigma * lq2 * lq2
        alpha_h, L_new_h = minimize_quartic_kernel(
            host(e), host(d1), host(c1), host(b1), host(a1),
            spec.alpha_max, eps)
        alpha = alpha_h.to(dev)
        L_new = L_new_h.to(dev)

        # algebraic commit + incremental products
        vio = vio + alpha * (alpha * q2 + q1)
        vio_lr = [vio_lr[i] + alpha * (alpha * p2_lr[t] + p1_lr[t])
                  for t, i in cons_idx.items()]
        obj = obj + alpha * (alpha * p2 + p1)
        Rt = Rt + alpha * direction
        CRt = CRt + alpha * CDt
        Q = Q + alpha * Qd

        # gradient, the stagnation test and the ring push (skipped when
        # stagnating), then the next direction's dots
        G_new = grad_of(Rt, CRt, Q, vio, vio_lr)
        L_old_h = host(L_val)
        rel_delta = (L_old_h - L_new_h) / torch.maximum(
            torch.ones_like(L_new_h),
            torch.maximum(L_new_h.abs(), L_old_h.abs()))
        stag = bool(rel_delta < stag_tol)
        if spec.use_hist and not stag:
            head = _push_plain(head, k, S2, Y2, sty, yty, rho,
                               alpha * direction, G_new - G)
        gsq = torch.sum(G_new * G_new)
        p = torch.cat([S2 @ G_new.reshape(-1), Y2 @ G_new.reshape(-1)])
        gnorm = torch.sqrt(gsq) / spec.gscale
        G = G_new
        L_val = L_new
        steps += 1

    oscal = torch.zeros(spec.n_scal_out, dtype=dtype, device=dev)
    oscal[0] = L_val
    oscal[1] = obj
    oscal[2] = gnorm
    oscal[3] = steps
    oscal[4] = float(stag)
    oscal[5] = alpha
    oscal[6] = head
    oscal[7:7 + k] = rho
    for i in range(n_lc):
        oscal[7 + k + i] = vio_lr[i]
    o = spec.o_gram
    oscal[o:o + k * k] = sty.reshape(-1)
    oscal[o + k * k:o + 2 * k * k] = yty.reshape(-1)
    return Rt, G, vio, oscal


def mega_chunk_armijo_plain(spec: MegaSpec, scal, C, Rt_in, LAM, W, Bc, UB,
                            WW, s_ring, y_ring, lr_B, lr_Bdt, lr_d):
    """K2's loop, step by step in torch, on the kernel's layout: the same
    inputs as the CUDA launch and the same outputs (Rt, G, vio (J,
    n_pad), oscal with the ring's SᵀY and YᵀY); the rings are updated in
    place.

    The sharp AL ℒ = obj + Σ(λ̃² − λ²)/(2σ), λ̃ = min(λ_ub, λ − σv), over
    the J channel rows, the wide constraints and the low-rank equality
    terms (megakernel.py:516-780). The direction is the compact L-BFGS
    form on Grams built from the ring at entry and refreshed on every
    push (its row and column), with slope ⟨G, D⟩ = −(gᵀg + wᵀp) from
    scalars, as the kernel computes them. The Armijo step is the first
    candidate α_max·2⁻ᵗ (t = 0..50) with ℒ(α) ≤ ℒ + c·α·⟨G, D⟩, else the
    last: the α of the sequential backtracking loop, with every candidate
    evaluated at once as the kernel does."""
    k, n_w = spec.k, spec.n_wide
    dtype, dev = Rt_in.dtype, Rt_in.device
    host = lambda x: x.detach().to("cpu")
    scal_h = host(scal)
    sigma = scal[0]
    cur_gtol = float(scal_h[1])
    stag_tol = scal_h[2]
    max_steps = int(scal_h[3])
    head = int(scal_h[4])
    rho = scal[5:5 + k].clone()
    n_lc = len(spec.lr_cons)
    o = 5 + k
    lam_lc, b_lc = scal[o:o + n_lc], scal[o + n_lc:o + 2 * n_lc]
    o += 2 * n_lc
    lam_w, b_w = scal[o:o + n_w], scal[o + n_w:o + 2 * n_w]
    ub_w = scal[o + 2 * n_w:o + 3 * n_w]
    WWv = WW[:n_w]
    sl = _lr_slices(spec)
    cons_idx = {t: i for i, t in enumerate(spec.lr_cons)}
    two_sigma = 2.0 * sigma

    def lr_tr(Qa, Qb, t):
        return torch.sum(Qa[:, sl[t]] * Qb[:, sl[t]] * lr_d[sl[t]])

    def tilde(lam, vio, ub):
        return torch.minimum(ub, lam - sigma * vio)

    def state_of(Rt, CRt, Q):
        obj = torch.sum(Rt * CRt)
        for t in range(spec.n_lr):
            if spec.lr_is_obj[t]:
                obj = obj + lr_tr(Q, Q, t)
        rv = torch.sum(Rt * Rt, dim=0, keepdim=True)
        vio = W * rv - Bc
        vio_w = WWv @ rv[0] - b_w
        vio_lr = [lr_tr(Q, Q, t) - b_lc[i] for t, i in cons_idx.items()]
        return obj, vio, vio_w, vio_lr

    def rest_of(vio_w, vio_lr):
        """ℒ's wide and low-rank terms (batched over leading axes)."""
        lt = tilde(lam_w, vio_w, ub_w)
        L = torch.sum((lt * lt - lam_w * lam_w) / two_sigma, dim=-1)
        for i in range(n_lc):
            lt = lam_lc[i] - sigma * vio_lr[i]
            L = L + (lt * lt - lam_lc[i] * lam_lc[i]) / two_sigma
        return L

    def al_of(obj, vio, vio_w, vio_lr):
        lt = tilde(LAM, vio, UB)
        return (obj + torch.sum(lt * lt - LAM * LAM) / two_sigma
                + rest_of(vio_w, vio_lr))

    def grad_of(Rt, CRt, Q, vio, vio_w, vio_lr):
        mu_row = torch.sum(W * -tilde(LAM, vio, UB), dim=0, keepdim=True)
        mu_row = mu_row + (-tilde(lam_w, vio_w, ub_w)) @ WWv
        G = 2.0 * (CRt + mu_row * Rt)
        for t in range(spec.n_lr):
            if spec.lr_is_obj[t]:
                y_t = 1.0
            else:
                i = cons_idx[t]
                y_t = -(lam_lc[i] - sigma * vio_lr[i])
            G = G + 2.0 * y_t * (Q[:, sl[t]] @ lr_Bdt[sl[t]])
        return G

    Rt = Rt_in.clone()
    CRt = Rt @ C
    Q = Rt @ lr_B
    obj, vio, vio_w, vio_lr = state_of(Rt, CRt, Q)
    L_val = al_of(obj, vio, vio_w, vio_lr)
    G = grad_of(Rt, CRt, Q, vio, vio_w, vio_lr)
    S2, Y2 = _ring_views(spec, s_ring, y_ring)
    sty, yty = S2 @ Y2.T, Y2 @ Y2.T
    gsq = torch.sum(G * G)
    p = torch.cat([S2 @ G.reshape(-1), Y2 @ G.reshape(-1)])
    gnorm = torch.sqrt(gsq) / spec.gscale
    steps, stag = 0, False
    alpha = torch.zeros((), dtype=dtype, device=dev)
    cand = armijo_candidates(float(spec.alpha_max), dtype, dev)
    ca = cand[:, None, None]

    while float(gnorm) > cur_gtol and steps < max_steps and not stag:
        direction, slope0 = -G, -gsq
        if spec.use_hist:
            w = _compact_w_plain(k, head, rho, sty, yty, p)
            descent = -(gsq + w @ p)
            if not (math.isnan(float(descent)) or float(descent) >= 0.0):
                direction = -(G + (w[:k] @ S2 + w[k:] @ Y2).reshape(G.shape))
                slope0 = descent

        # line-search products, shared by every candidate step
        CDt = direction @ C
        p1 = 2.0 * torch.sum(Rt * CDt)
        p2 = torch.sum(direction * CDt)
        rv1 = 2.0 * torch.sum(Rt * direction, dim=0, keepdim=True)
        rv2 = torch.sum(direction * direction, dim=0, keepdim=True)
        q1, q2 = W * rv1, W * rv2
        q1_w, q2_w = WWv @ rv1[0], WWv @ rv2[0]
        Qd = direction @ lr_B
        p1_lr = [2.0 * lr_tr(Q, Qd, t) for t in range(spec.n_lr)]
        p2_lr = [lr_tr(Qd, Qd, t) for t in range(spec.n_lr)]
        for t in range(spec.n_lr):
            if spec.lr_is_obj[t]:
                p1 = p1 + p1_lr[t]
                p2 = p2 + p2_lr[t]

        # ℒ at every candidate; the first that passes the Armijo test
        lt = tilde(LAM, vio + ca * (ca * q2 + q1), UB)
        L_all = (obj + cand * (cand * p2 + p1)
                 + torch.sum(lt * lt - LAM * LAM, dim=(1, 2)) / two_sigma)
        cw = cand[:, None]
        L_all = L_all + rest_of(
            vio_w + cw * (cw * q2_w + q1_w),
            [vio_lr[i] + cand * (cand * p2_lr[t] + p1_lr[t])
             for t, i in cons_idx.items()])
        alpha, L_new = armijo_pick(cand, L_all,
                                   L_val + ARMIJO_C * cand * slope0)

        # algebraic commit + incremental products
        vio = vio + alpha * (alpha * q2 + q1)
        vio_w = vio_w + alpha * (alpha * q2_w + q1_w)
        vio_lr = [vio_lr[i] + alpha * (alpha * p2_lr[t] + p1_lr[t])
                  for t, i in cons_idx.items()]
        obj = obj + alpha * (alpha * p2 + p1)
        Rt = Rt + alpha * direction
        CRt = CRt + alpha * CDt
        Q = Q + alpha * Qd

        G_new = grad_of(Rt, CRt, Q, vio, vio_w, vio_lr)
        L_old_h, L_new_h = host(L_val), host(L_new)
        rel_delta = (L_old_h - L_new_h) / torch.maximum(
            torch.ones_like(L_new_h),
            torch.maximum(L_new_h.abs(), L_old_h.abs()))
        stag = bool(rel_delta < stag_tol)
        if spec.use_hist and not stag:
            head = _push_plain(head, k, S2, Y2, sty, yty, rho,
                               alpha * direction, G_new - G)
        gsq = torch.sum(G_new * G_new)
        p = torch.cat([S2 @ G_new.reshape(-1), Y2 @ G_new.reshape(-1)])
        gnorm = torch.sqrt(gsq) / spec.gscale
        G = G_new
        L_val = L_new
        steps += 1

    oscal = torch.zeros(spec.n_scal_out, dtype=dtype, device=dev)
    oscal[0] = L_val
    oscal[1] = obj
    oscal[2] = gnorm
    oscal[3] = steps
    oscal[4] = float(stag)
    oscal[5] = alpha
    oscal[6] = head
    oscal[7:7 + k] = rho
    o_vw = 7 + k + max(n_lc, 1)
    for i in range(n_lc):
        oscal[7 + k + i] = vio_lr[i]
    oscal[o_vw:o_vw + n_w] = vio_w
    o = spec.o_gram
    oscal[o:o + k * k] = sty.reshape(-1)
    oscal[o + k * k:o + 2 * k * k] = yty.reshape(-1)
    return Rt, G, vio, oscal


# --------------------------------------------------------------------------
# the CUDA kernel: build, plan, launch
# --------------------------------------------------------------------------

class _K1Args(ctypes.Structure):
    """Mirror of ``struct K1Args`` in csrc/megakernel.cu (field order)."""

    _fields_ = (
        [(f, ctypes.c_int) for f in (
            "n_pad", "rp", "k", "use_hist", "n_lr", "n_lc", "lrc",
            "is_double")]
        + [("lr_off", ctypes.c_int * (MAX_LR_TERMS + 1)),
           ("lr_cons", ctypes.c_int * MAX_LR_TERMS),
           ("device", ctypes.c_int),
           ("gscale", ctypes.c_double), ("alpha_max", ctypes.c_double)]
        + [(f, ctypes.c_void_p) for f in (
            "scal", "C", "Rt_in", "lam", "w", "b", "s_ring", "y_ring",
            "lrB", "lrBdt", "lrd", "Rt_out", "G_out", "vio_out", "oscal",
            "work", "tbuf", "stream")]
        + [(f, ctypes.c_int) for f in (
            "S", "nblk", "smem_bytes", "sms", "blocks_per_sm", "c_resident",
            "ring_resident")]
        + [("work_elems", ctypes.c_longlong)]
    )


class _K2Args(ctypes.Structure):
    """Mirror of ``struct K2Args`` in csrc/megakernel_armijo.cu (field
    order)."""

    _fields_ = (
        [(f, ctypes.c_int) for f in (
            "n_pad", "rp", "k", "use_hist", "n_lr", "n_lc", "lrc",
            "is_double", "J", "n_w")]
        + [("lr_off", ctypes.c_int * (MAX_LR_TERMS + 1)),
           ("lr_cons", ctypes.c_int * MAX_LR_TERMS),
           ("device", ctypes.c_int),
           ("gscale", ctypes.c_double), ("alpha_max", ctypes.c_double)]
        + [(f, ctypes.c_void_p) for f in (
            "scal", "C", "Rt_in", "LAM", "W", "B", "UB", "WW", "s_ring",
            "y_ring", "lrB", "lrBdt", "lrd", "Rt_out", "G_out", "vio_out",
            "oscal", "work", "tbuf", "stream")]
        + [(f, ctypes.c_int) for f in (
            "S", "nblk", "smem_bytes", "sms", "blocks_per_sm", "c_resident")]
        + [("work_elems", ctypes.c_longlong)]
    )


class CudaKernel:
    """A kernel's shared library, built from ``csrc/<source>`` at first
    use (``utils/build.CudaLibrary``), and its launch count
    (``launches``: one per kernel launch on the main path; nothing else
    adds to it). The library exports ``<prefix>_limits``, ``_plan``,
    ``_launch`` and ``_error_string``."""

    def __init__(self, name: str, source: str, prefix: str, args_type,
                 limits: tuple, defines: tuple = ()):
        self.name, self.prefix = name, prefix
        self.args_type, self.limits = args_type, limits
        self.launches = 0
        by_ref = [ctypes.POINTER(args_type)]
        self.lib = CudaLibrary(
            source, {f"{prefix}_limits": [ctypes.POINTER(ctypes.c_int)],
                     f"{prefix}_plan": by_ref, f"{prefix}_launch": by_ref},
            f"{prefix}_error_string", on_load=self._check_limits,
            defines=defines)

    def _check_limits(self, lib):
        want = self.limits + (ctypes.sizeof(self.args_type),)
        lim = (ctypes.c_int * len(want))()
        getattr(lib, f"{self.prefix}_limits")(lim)
        if tuple(lim) != want:
            raise RuntimeError(
                f"{self.lib.source} limits {tuple(lim)} disagree with the "
                f"wrapper's {want}")

    @property
    def built(self):
        return self.lib.built

    def plan(self, args):
        self.lib.call(f"{self.prefix}_plan", ctypes.byref(args),
                      what=f"{self.name} plan")
        if args.blocks_per_sm * args.sms < args.nblk or args.S > 16:
            raise RuntimeError(
                f"{self.name} grid of {args.nblk} blocks ({args.S} columns "
                f"each) is not co-resident on {args.sms} SMs at "
                f"{args.blocks_per_sm} block(s) per SM")
        return args

    def launch(self, args):
        self.plan(args)
        self.lib.call(f"{self.prefix}_launch", ctypes.byref(args),
                      what=f"{self.name} launch")
        self.launches += 1


_COMMON_LIMITS = (MAX_RP, 16, MAX_K, MAX_LR_TERMS, MAX_LR_COLS, N_CHUNK)
_K2_LIMITS = _COMMON_LIMITS + (MAX_DIAG_CHANNELS, MAX_WIDE, N_CAND)
K1 = CudaKernel("K1", "megakernel.cu", "k1", _K1Args, _COMMON_LIMITS)
K2 = CudaKernel("K2", "megakernel_armijo.cu", "k2", _K2Args, _K2_LIMITS)
# Timing builds (-DK1_TIMING, -DK2_TIMING): the same sources with
# per-phase %globaltimer stamps and a barrier count, written to a ``tbuf``
# (``phase_times``). Only the measurement of the kernels' phases launches
# them (chip_smoke.py phases 5 and 8), on their own launch counts; the
# two-loop builds are each kernel's design before its compact redesign,
# kept as that measurement's baseline.
K1_TIMED = CudaKernel("K1 timing build", "megakernel.cu", "k1", _K1Args,
                      _COMMON_LIMITS, defines=("K1_TIMING",))
K1_TWOLOOP_TIMED = CudaKernel(
    "K1 two-loop baseline, timing build", "megakernel_twoloop.cu", "k1",
    _K1Args, _COMMON_LIMITS, defines=("K1_TIMING",))
K2_TIMED = CudaKernel("K2 timing build", "megakernel_armijo.cu", "k2",
                      _K2Args, _K2_LIMITS, defines=("K2_TIMING",))
K2_TWOLOOP_TIMED = CudaKernel(
    "K2 two-loop baseline, timing build", "megakernel_armijo_twoloop.cu",
    "k2", _K2Args, _K2_LIMITS, defines=("K2_TIMING",))


def _args_for(spec: MegaSpec, dtype, device, args_type=_K1Args):
    a = args_type()
    a.n_pad, a.rp, a.k = spec.n_pad, spec.rp, spec.k
    a.use_hist = int(spec.use_hist)
    a.n_lr, a.n_lc = spec.n_lr, len(spec.lr_cons)
    a.lrc = int(sum(spec.lr_sizes))
    a.is_double = int(dtype == torch.float64)
    off = np.concatenate([[0], np.cumsum(spec.lr_sizes)]).astype(int)
    for t in range(MAX_LR_TERMS + 1):
        a.lr_off[t] = int(off[min(t, spec.n_lr)])
    cons = {t: i for i, t in enumerate(spec.lr_cons)}
    for t in range(MAX_LR_TERMS):
        a.lr_cons[t] = cons.get(t, -1)
    a.device = device.index if device.index is not None \
        else torch.cuda.current_device()
    a.gscale, a.alpha_max = float(spec.gscale), float(spec.alpha_max)
    return a


def _check_args(name: str, want: dict, got: dict, dtype, dev):
    for arg, x in got.items():
        if tuple(x.shape) != want[arg] or x.dtype != dtype \
                or x.device != dev or not x.is_contiguous():
            raise ValueError(
                f"{name} argument {arg}: want contiguous {want[arg]} "
                f"{dtype} on {dev}, got {tuple(x.shape)} {x.dtype} on "
                f"{x.device}")


def _check_launchable(name: str, spec: MegaSpec, dtype, dev):
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} runs in float32 or float64, got {dtype}")
    if spec.n_pad > MAX_N_PAD or spec.n_pad % N_CHUNK or spec.rp > MAX_RP \
            or spec.rp % 8 or spec.k > MAX_K \
            or sum(spec.lr_sizes) > MAX_LR_COLS or spec.n_lr > MAX_LR_TERMS \
            or spec.J > MAX_DIAG_CHANNELS or spec.n_wide > MAX_WIDE:
        raise ValueError(f"{name} layout limits exceeded by {spec}")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr() if x.numel() else 0)


def mega_kernel(spec: MegaSpec, scal, C, Rt_in, lam_row, w_row, b_row,
                s_ring, y_ring, lr_B, lr_Bdt, lr_d, *, kernel=None,
                tbuf=None):
    """Launch K1 on CUDA tensors: the same arguments and results as
    ``mega_chunk_plain``; ``s_ring``/``y_ring`` are updated in place. The
    launch goes on the current stream and does not synchronise.
    ``kernel`` and ``tbuf`` are for the timing builds only
    (``phase_times``)."""
    kernel = K1 if kernel is None else kernel
    dtype, dev = Rt_in.dtype, Rt_in.device
    n, rp, k = spec.n_pad, spec.rp, spec.k
    lrc = int(sum(spec.lr_sizes))
    _check_launchable("K1", spec, dtype, dev)
    want = {
        "scal": (5 + k + 2 * len(spec.lr_cons),), "C": (n, n),
        "Rt_in": (rp, n), "lam_row": (1, n), "w_row": (1, n),
        "b_row": (1, n), "s_ring": (k * rp, n), "y_ring": (k * rp, n),
        "lr_B": (n, lrc), "lr_Bdt": (lrc, n), "lr_d": (lrc,),
    }
    got = dict(scal=scal, C=C, Rt_in=Rt_in, lam_row=lam_row, w_row=w_row,
               b_row=b_row, s_ring=s_ring, y_ring=y_ring, lr_B=lr_B,
               lr_Bdt=lr_Bdt, lr_d=lr_d)
    _check_args("K1", want, got, dtype, dev)
    a = kernel.plan(_args_for(spec, dtype, dev))
    if kernel.lib.source == K1.lib.source:
        want = k1_smem_plan(n, rp, k, lrc, torch.finfo(dtype).bits // 8,
                            a.sms)
        got = (a.smem_bytes, bool(a.c_resident), bool(a.ring_resident))
        if want != got:
            raise RuntimeError(
                f"K1 plans {got} (shared bytes, C resident, ring "
                f"resident), the wrapper's mirror {want}")
    Rt_out = torch.empty((rp, n), dtype=dtype, device=dev)
    G_out = torch.empty((rp, n), dtype=dtype, device=dev)
    vio_out = torch.empty((1, n), dtype=dtype, device=dev)
    oscal = torch.zeros(spec.n_scal_out, dtype=dtype, device=dev)
    work = torch.empty(int(a.work_elems), dtype=dtype, device=dev)
    a.scal, a.C, a.Rt_in = _ptr(scal), _ptr(C), _ptr(Rt_in)
    a.lam, a.w, a.b = _ptr(lam_row), _ptr(w_row), _ptr(b_row)
    a.s_ring, a.y_ring = _ptr(s_ring), _ptr(y_ring)
    a.lrB, a.lrBdt, a.lrd = _ptr(lr_B), _ptr(lr_Bdt), _ptr(lr_d)
    a.Rt_out, a.G_out, a.vio_out = _ptr(Rt_out), _ptr(G_out), _ptr(vio_out)
    a.oscal, a.work = _ptr(oscal), _ptr(work)
    if tbuf is not None:
        a.tbuf = _ptr(tbuf)
    a.stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    kernel.launch(a)
    return Rt_out, G_out, vio_out, oscal


def mega_kernel_armijo(spec: MegaSpec, scal, C, Rt_in, LAM, W, Bc, UB, WW,
                       s_ring, y_ring, lr_B, lr_Bdt, lr_d, *, kernel=None,
                       tbuf=None):
    """Launch K2 on CUDA tensors: the same arguments and results as
    ``mega_chunk_armijo_plain``; ``s_ring``/``y_ring`` are updated in
    place. The launch goes on the current stream and does not
    synchronise. ``kernel`` and ``tbuf`` are for the timing builds only
    (``phase_times``)."""
    kernel = K2 if kernel is None else kernel
    dtype, dev = Rt_in.dtype, Rt_in.device
    n, rp, k, J, n_w = spec.n_pad, spec.rp, spec.k, spec.J, spec.n_wide
    lrc = int(sum(spec.lr_sizes))
    _check_launchable("K2", spec, dtype, dev)
    want = {
        "scal": (5 + k + 2 * len(spec.lr_cons) + 3 * n_w,), "C": (n, n),
        "Rt_in": (rp, n), "LAM": (J, n), "W": (J, n), "Bc": (J, n),
        "UB": (J, n), "WW": (max(n_w, 1), n), "s_ring": (k * rp, n),
        "y_ring": (k * rp, n), "lr_B": (n, lrc), "lr_Bdt": (lrc, n),
        "lr_d": (lrc,),
    }
    got = dict(scal=scal, C=C, Rt_in=Rt_in, LAM=LAM, W=W, Bc=Bc, UB=UB,
               WW=WW, s_ring=s_ring, y_ring=y_ring, lr_B=lr_B,
               lr_Bdt=lr_Bdt, lr_d=lr_d)
    _check_args("K2", want, got, dtype, dev)
    a = _args_for(spec, dtype, dev, _K2Args)
    a.J, a.n_w = J, n_w
    a = kernel.plan(a)
    if kernel.lib.source == K2.lib.source:
        want = k2_smem_plan(n, rp, k, lrc, torch.finfo(dtype).bits // 8,
                            a.sms)
        if want != (a.smem_bytes, bool(a.c_resident)):
            raise RuntimeError(
                f"K2 plans {a.smem_bytes} B of shared memory (C resident: "
                f"{bool(a.c_resident)}), the wrapper's mirror {want}")
    Rt_out = torch.empty((rp, n), dtype=dtype, device=dev)
    G_out = torch.empty((rp, n), dtype=dtype, device=dev)
    vio_out = torch.empty((J, n), dtype=dtype, device=dev)
    oscal = torch.zeros(spec.n_scal_out, dtype=dtype, device=dev)
    work = torch.empty(int(a.work_elems), dtype=dtype, device=dev)
    a.scal, a.C, a.Rt_in = _ptr(scal), _ptr(C), _ptr(Rt_in)
    a.LAM, a.W, a.B, a.UB, a.WW = _ptr(LAM), _ptr(W), _ptr(Bc), _ptr(UB), \
        _ptr(WW)
    a.s_ring, a.y_ring = _ptr(s_ring), _ptr(y_ring)
    a.lrB, a.lrBdt, a.lrd = _ptr(lr_B), _ptr(lr_Bdt), _ptr(lr_d)
    a.Rt_out, a.G_out, a.vio_out = _ptr(Rt_out), _ptr(G_out), _ptr(vio_out)
    a.oscal, a.work = _ptr(oscal), _ptr(work)
    if tbuf is not None:
        a.tbuf = _ptr(tbuf)
    a.stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    kernel.launch(a)
    return Rt_out, G_out, vio_out, oscal


def phase_times(kernel, spec: MegaSpec, args: tuple, steps: int):
    """One launch of a timing build (``K1_TIMED``, ``K1_TWOLOOP_TIMED``,
    ``K2_TIMED`` or ``K2_TWOLOOP_TIMED``; K2's when ``spec.armijo``) of
    exactly ``steps`` iterations from ``mega_inputs``' arguments (the
    rings are copied first): returns ({phase: µs per iteration}, grid
    barriers per iteration, barriers at entry), from block 0's
    %globaltimer sums."""
    lib = kernel.lib.built.lib
    phases = getattr(lib, f"{kernel.prefix}_phases")
    phases.restype = ctypes.c_char_p
    names = phases().decode().split(",")
    scal = args[0].clone()
    scal[3] = steps
    s_ring, y_ring = (x.clone() for x in rings_of(spec, args))
    tbuf = torch.zeros(len(names) + 2, dtype=torch.int64,
                       device=args[0].device)
    if spec.armijo:
        out = mega_kernel_armijo(spec, scal, *args[1:8], s_ring, y_ring,
                                 *args[10:], kernel=kernel, tbuf=tbuf)
    else:
        out = mega_kernel(spec, scal, *args[1:6], s_ring, y_ring,
                          *args[8:], kernel=kernel, tbuf=tbuf)
    t = tbuf.cpu().tolist()
    done = int(out[3][3].item())
    if done != steps:
        raise RuntimeError(f"{kernel.name} ran {done} of {steps} steps")
    per_it = {nm: t[i] / 1e3 / steps for i, nm in enumerate(names)}
    n_ph = len(names)
    return per_it, (t[n_ph] - t[n_ph + 1]) / steps, t[n_ph + 1]


def _lr_cons_gids(spec: MegaSpec):
    return [g for t, g in enumerate(spec.lr_gids) if not spec.lr_is_obj[t]]


def mega_inputs(spec: MegaSpec, r: int, data, R, lbfgs, lam, sigma,
                cur_gtol, stag_tol, max_steps) -> tuple:
    """The kernel's arguments from the inner-loop state (the transposes
    and rank padding of megakernel.py:1204-1216 and :1107-1138). K1:
    (scal, C, Rt, lam_row, w_row, b_row, s_ring, y_ring, lr_B, lr_Bdt,
    lr_d); K2: (scal, C, Rt, LAM, W, B, UB, WW, s_ring, y_ring, lr_B,
    lr_Bdt, lr_d). ``scal`` is built on the device, so a launch needs no
    host sync."""
    dtype, dev = R.dtype, R.device
    n_pad, rp, kk = spec.n_pad, spec.rp, spec.k
    f = lambda x: torch.as_tensor(x, dtype=dtype).to(dev).reshape(1)
    none = torch.zeros(0, dtype=dtype, device=dev)

    Rt = torch.zeros((rp, n_pad), dtype=dtype, device=dev)
    Rt[:r] = R.T
    lam_ext = torch.cat([lam, torch.zeros(1, dtype=dtype, device=dev)])

    # (k, n_pad, r) -> (k*rp, n_pad): transposed + rank-padded
    def to_kern(h):
        ht = torch.zeros((kk, rp, n_pad), dtype=dtype, device=dev)
        ht[:, :r] = h.transpose(1, 2)
        return ht.reshape(kk * rp, n_pad)

    gids = _lr_cons_gids(spec)
    scal = [
        f(sigma), f(cur_gtol), f(stag_tol), f(float(max_steps)),
        f(float(lbfgs.head)), lbfgs.rho.to(dtype),
        lam[gids] if gids else none, data.b_lr,
    ]
    rings = (to_kern(lbfgs.s_hist), to_kern(lbfgs.y_hist))
    lr = (data.lr_B, data.lr_Bdt, data.lr_d)
    if not spec.armijo:
        lam_row = lam_ext[data.cid_dev].reshape(1, n_pad)
        return (torch.cat(scal), data.C, Rt, lam_row, data.w_row,
                data.b_row) + rings + lr
    wg = list(spec.wide_gids)
    scal += [lam[wg] if wg else none, data.b_wide, data.ub_wide]
    LAM = lam_ext[data.cid_ch.reshape(-1)].reshape(spec.J, n_pad)
    return (torch.cat(scal), data.C, Rt, LAM, data.W_ch, data.B_ch,
            data.UB_ch, data.WW) + rings + lr


def rings_of(spec: MegaSpec, args: tuple):
    """(s_ring, y_ring) among ``mega_inputs``' arguments."""
    return args[8:10] if spec.armijo else args[6:8]


def mega_carry(spec: MegaSpec, r: int, m: int, pscale: float, data, lam,
               sigma, s_ring, y_ring, outputs):
    """(InnerCarry, vio_norm) from the kernel's outputs (Rt, G, vio,
    oscal) and its rings — the unpacking of megakernel.py:1240-1269 (K1)
    and :1146-1181 (K2)."""
    from ..solver.inner import InnerCarry
    from ..solver.lbfgs import LBFGSState

    Rt_o, G_o, vio_o, osc = outputs
    dtype, dev = Rt_o.dtype, Rt_o.device
    n_pad, rp, kk = spec.n_pad, spec.rp, spec.k
    o_vlr = 7 + kk

    def from_kern(h2):
        return h2.reshape(kk, rp, n_pad)[:, :r].transpose(1, 2).contiguous()

    osc_h = osc.detach().to("cpu")
    vio_raw = torch.zeros(m + 1, dtype=dtype, device=dev)
    if spec.armijo:
        # channel violations to the m-vector; padding and wide slots
        # write slot m, which the assignments below overwrite
        vio_raw[data.cid_ch.reshape(-1)] = vio_o.reshape(-1)
        o_vw = o_vlr + max(len(spec.lr_cons), 1)
        for i, g in enumerate(spec.wide_gids):
            vio_raw[g] = osc[o_vw + i]
    else:
        vio_raw[data.cid_dev] = vio_o[0]
    for i, g in enumerate(_lr_cons_gids(spec)):
        vio_raw[g] = osc[o_vlr + i]
    vio_raw[m] = osc[1]
    lam_t = torch.minimum(data.lam_ub, lam - sigma * vio_raw[:m])
    y_full = torch.cat([-lam_t, torch.ones(1, dtype=dtype, device=dev)])
    o = spec.o_gram
    sty = osc[o:o + kk * kk].reshape(kk, kk).clone()
    yty = osc[o + kk * kk:o + 2 * kk * kk].reshape(kk, kk).clone()
    new_lbfgs = LBFGSState(
        s_hist=from_kern(s_ring), y_hist=from_kern(y_ring),
        rho=osc[7:7 + kk].clone(), head=int(osc_h[6]), sty=sty, yty=yty)
    carry = InnerCarry(
        R=Rt_o[:r].T.contiguous(), G=G_o[:r].T.contiguous(), y_full=y_full,
        vio_raw=vio_raw, L_val=osc[0], grad_norm=osc[2], lbfgs=new_lbfgs,
        steps=int(osc_h[3]), stagnated=bool(osc_h[4] > 0),
    )
    vio = torch.maximum(vio_raw[:m], data.vio_lb)
    return carry, torch.linalg.norm(vio) / pscale


def mega_chunk(spec: MegaSpec, r: int, m: int, pscale: float, data, R,
               lbfgs, lam, sigma, cur_gtol, stag_tol, max_steps):
    """One inner activation through K1, or K2 when ``spec.armijo`` — the
    ``mega_chunk_traced`` contract (megakernel.py:1184-1269): returns
    (InnerCarry, vio_norm). CUDA tensors launch the kernel; CPU tensors
    run its plain version."""
    args = mega_inputs(spec, r, data, R, lbfgs, lam, sigma, cur_gtol,
                       stag_tol, max_steps)
    if spec.armijo:
        run = mega_kernel_armijo if R.device.type == "cuda" \
            else mega_chunk_armijo_plain
    else:
        run = mega_kernel if R.device.type == "cuda" else mega_chunk_plain
    outputs = run(spec, *args)
    return mega_carry(spec, r, m, pscale, data, lam, sigma,
                      *rings_of(spec, args), outputs)
