"""Outer augmented-Lagrangian driver and the public ``sdplr`` entry point.

Counterpart of the JAX package's ``solver/outer.py`` (reference:
src/sdplr.jl:91-449). The host holds (R, λ, σ, r, tolerances, timers)
and calls the state machine of solver/major.py, which advances the solve
by up to ``config.inner_chunk`` inner steps and every major-iteration
boundary it crosses; the host checks wall-clock limits, prints, and
re-specializes shapes on rank doubling. After the solve come the host
f64 dual polish and the reseed ladder.

The inner engines: the dense engine (C held dense: MaxCut, MinBisection,
CutNorm at n_pad ≤ 2048), the fast-diagonal engine (every constraint
entry diagonal, C kept sparse: MaxCut and its kin past n_pad 2048,
μ-conductance), the entry-mask engine (the single-entry equality
families, Lovász θ, at n_pad ≤ 8192; solver/inner_entry.py), and the
general engine (off-diagonal constraint entries otherwise: θ past n_pad
8192 or with ``entry_mode=False``, and external models through
``solve_model``), each with equality constraints (exact line search) or
inequalities (Armijo); the CUDA megakernels K1 and K2 take eligible
problems on the card. θ's trace-normalized scaling is conditioned first
(``_maybe_rescale_entry``), whatever the engine. The dual bound is the
scalar or block Lanczos (block past n = 4096, when forced, or when the
scalar schedule wants more than 1024 steps).

Two drivers run the same mathematics: the fused driver (``_solve_fused``,
the default), whose state machine crosses many major boundaries per
call, and the host-driven loop (``_solve_host``, ``fused_outer=False``),
which reads the state on the host after every inner chunk. Both write a
checkpoint at major boundaries when ``checkpoint_path`` is set
(utils/checkpoint.py); ``profile_dir`` records the solve with
torch.profiler.

Multi-device solving (``devices > 1``, or ``solve(..., mesh=...)``)
row-shards the solve as the JAX package's shard_map path does
(parallel/shardmap.py): each rank places only its rank-local problem on
its device, and the carries stay row-sharded between chunks; the whole
factor is all-gathered for a checkpoint, a rank doubling and the
result. The host's decisions on elapsed time read rank 0's clock, and
the result and the host polish are rank 0's, broadcast. With a process
group already initialized every rank calls ``sdplr`` (SPMD); otherwise
``devices`` workers are started here and rank 0's result is returned.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..adapter import CustomModel
from ..compile import compile_problem
from ..config import SolverConfig, resolve_device, resolve_dtype
from ..ops.blocklanczos import block_sizes
from ..ops.device import DeviceProblem, fast_diag_eligible, to_device
from ..ops.entrymask import entry_enabled
from ..ops.lanczos import bucket_q_max, lanczos_q
from ..problem import SDPProblem
from ..utils.checkpoint import save_checkpoint
from ..utils.printing import print_heading, print_intermediate
from .dualbound import dimacs_errors, dual_obj
from .al import al_value_grad
from .inner import inner_chunk
from .inner_entry import EntryGraphs, entry_chunk
from .lbfgs import lbfgs_clear, lbfgs_init
from .rank import next_rank

_EPS64 = float(np.finfo(np.float64).eps)

ENGINE_KERNEL = "cuda-megakernel"     # K1 or K2 on the card
ENGINE_PLAIN = "megakernel-plain"     # their plain versions (CPU tensors)
ENGINE_TORCH = "dense-torch"          # the torch inner loop, dense C
ENGINE_FAST = "fast-diag-torch"       # the torch inner loop, sparse C
ENGINE_ENTRY = "entry-mask-torch"     # the dense-mask loop (Lovász θ)
ENGINE_GENERAL = "general-torch"      # the torch inner loop, general 𝒜


def _init_vars(prob, dp, r: int, config: SolverConfig, dtype,
               rng: np.random.Generator):
    """Fresh (R0 padded, λ0) — random uniform(-1, 1) like the reference
    (src/structs.jl:237), drawn with numpy so the JAX package starts from
    the same factor, or via a user init_func (src/structs.jl:231-234).
    init_func(problem, r, *init_args) must return (R0 [n, r], lam0 [m])."""
    n, m = dp.n, dp.m
    if config.init_func is not None:
        R0, lam0 = config.init_func(prob, r, *config.init_args)
        R0 = np.asarray(R0, dtype=np.float64)
        if R0.shape == (r, n):
            R0 = R0.T
        if R0.shape != (n, r):
            raise ValueError(
                f"init_func returned R0 of shape {R0.shape}, want ({n},{r})")
        lam0 = np.minimum(np.asarray(lam0, dtype=np.float64).reshape(-1),
                          dp.lam_ub.cpu().numpy())
    else:
        R0 = rng.uniform(-1.0, 1.0, size=(n, r))
        lam0 = np.zeros(m)
    Rp = np.zeros((dp.n_pad, r))
    Rp[:n] = R0
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dp.device)
    return t(Rp), t(lam0)


def _warm_vars(dp, R, r_new: int, rng: np.random.Generator, dtype):
    """Rank-doubling warm start: keep the factor's columns and append
    small random columns (~1% of ‖R‖_F). The reference restarts R on
    every rank update (src/coreop.jl:518-526); rank_update_mode='restart'
    reproduces that."""
    n = dp.n
    R_old = R[:n].detach().cpu().numpy().astype(np.float64)
    r_old = R_old.shape[1]
    extra = rng.uniform(-1.0, 1.0, size=(n, r_new - r_old))
    scale = 1e-2 * max(np.linalg.norm(R_old), 1.0) / max(
        np.linalg.norm(extra), 1e-30)
    Rp = np.zeros((dp.n_pad, r_new))
    Rp[:n, :r_old] = R_old
    Rp[:n, r_old:] = scale * extra
    return torch.as_tensor(Rp, dtype=dtype, device=dp.device)


def _gtol_floor(config: SolverConfig, dtype) -> float:
    """Floor for the per-major stationarity tolerance: a few ulps of the
    compute dtype (or the user's gtol), so float32 schedules cannot
    underflow to 0 (the reference tightens cur_gtol /= σ without bound,
    src/sdplr.jl:358-364)."""
    return max(config.gtol, 8.0 * float(torch.finfo(dtype).eps))


def _stagnation_tol(config: SolverConfig, dtype) -> float:
    """fprec·eps threshold (reference: src/sdplr.jl:239 uses Float64 eps),
    floored at a few float32 ulps in float32 (unless fprec == 0)."""
    tol = config.fprec * _EPS64
    if config.fprec > 0 and dtype == torch.float32:
        tol = max(tol, 4.0 * float(np.finfo(np.float32).eps))
    return tol


def _entry_mix(dp, vio_raw):
    """The entry certificate's pieces at raw violations ``vio_raw``, on
    the host in float64: (lin, mixed, mix_obj), lin and mixed None when
    the wide constraint leaves no PSD scaling (b_w + v_w ≤ 0). lin = s·obj − ⟨C, E⟩
    is the linear-feasible value of X̂ − E (X̂ = s·RRᵀ meets the wide
    constraint, E zeroes the entry violations); mixed charges its PSD
    repair, the mix with X_I = c·I at t = δ/(δ + c), δ = ‖E‖_F."""
    v = np.asarray(vio_raw, dtype=np.float64)
    gid_w = int(dp.extra_gids[0])
    b_w = float(dp.b[gid_w])
    c_mix = float(dp.entry_mix_c)
    mix_obj = c_mix * dp.n * float(dp.trC_n)
    denom = b_w + v[gid_w]
    if denom <= 0:
        return None, None, mix_obj
    s = b_w / denom
    ve = v[dp.entry_gids.cpu().numpy()]
    cE = s * float(np.sum(dp.entry_csgn.cpu().numpy().astype(np.float64)
                          * ve))
    lin = s * float(v[dp.m]) - cE
    delta = s * float(np.sqrt(2.0 * np.sum(ve * ve)))
    t_mix = delta / max(delta + c_mix, 1e-300)
    return lin, (1.0 - t_mix) * lin + t_mix * mix_obj, mix_obj


def _entry_term_obj(dp, vio_raw, objtol: float, objtol_relative: bool):
    """Host mirror of the state machine's entry-mode termination
    objective (solver/major.entry_certified_obj): the mixed certificate
    when its PSD-repair overhead fits half the objtol budget, else the
    linear-feasible value plus that half (the host-driven loop's)."""
    lin, mixed, mix_obj = _entry_mix(dp, vio_raw)
    if lin is None:
        return mix_obj
    budget = 0.5 * objtol * (max(abs(lin), 1e-8) if objtol_relative
                             else 1.0)
    return min(mixed, lin + budget)


def _wide_w(dp) -> np.ndarray:
    """The wide constraint's weights wᵢ (n,) in float64, gathered from the
    ranks' column blocks on a rank-local problem (every rank certifies
    the same gathered factor, so all take this collective together)."""
    from ..parallel.comm import dp_full

    w = dp_full(dp, dp.extra_wide_w[0][:, None].contiguous())[:, 0]
    return w[:dp.n].detach().cpu().numpy().astype(np.float64)


def _greedy_is_objective(prob, dp, R_np: np.ndarray):
    """⟨C, χχᵀ⟩·b_w/Σ_S w for a greedy independent set S of the entry
    pattern, vertices tried in decreasing ‖R_i‖²: a true feasible
    objective for the θ family (entries are edges with b_e = 0, the wide
    constraint holds by the scaling, χχᵀ ⪰ 0). The analog of the
    reference's rounding callbacks (exps/test.jl:76-87) promoted to a
    certificate. None when it does not apply."""
    from ..problem import SparseSym, SymLowRank

    n = dp.n
    adj = [[] for _ in range(n)]
    for i, j in zip(dp.entry_rows.tolist(), dp.entry_cols.tolist()):
        if i < n and j < n and i != j:
            adj[i].append(j)
            adj[j].append(i)
    chosen = np.zeros(n, dtype=bool)
    blocked = np.zeros(n, dtype=bool)
    for v in np.argsort(-np.sum(R_np * R_np, axis=1)):
        if blocked[v]:
            continue
        chosen[v] = True
        for u in adj[v]:
            blocked[u] = True
        blocked[v] = True
    S = np.nonzero(chosen)[0]
    if S.size == 0:
        return None
    chi = np.zeros(n)
    chi[S] = 1.0
    # X̃ = (b_w / Σ_{i∈S} w_i)·χχᵀ meets the wide constraint exactly
    b_w = float(dp.b[int(dp.extra_gids[0])])
    wS = float(np.sum(_wide_w(dp)[S]))
    if wS <= 0:
        return None
    C = prob.C
    if isinstance(C, SymLowRank):
        Bc = C.B.T @ chi
        val = float(np.sum(C.d * Bc * Bc))
    elif isinstance(C, SparseSym):
        val = float(np.sum(C.vals * chi[C.rows] * chi[C.cols]))
    else:
        return None
    return val * b_w / wS


ENTRY_EIG_MAX_N = 4096   # _entry_eig_cert's dense host eigenvalue, n ≤ this


def _entry_eig_cert(prob, dp, R_np: np.ndarray):
    """The entry mode's PSD-repaired mix at its tightest δ, built from the
    factor on the host in float64. M = s·RRᵀ with the entry positions
    zeroed meets every linear constraint exactly: s = b_w/Σᵢ wᵢ‖Rᵢ‖²
    meets the wide one, and the entries are off-diagonal with b_e = 0
    (the compile gate of ``entry_trace_cert``). (1 − t)·M + t·c·I is then
    PSD for t = δ/(δ + c) once δ ≥ −λ_min(M); δ is −λ_min(M) from a
    dense symmetric eigensolver plus 4·n·eps·‖M‖_F for its rounding; c·I
    alone is taken where it is better (far from the optimum). The JAX
    package's repair (``_entry_mix``) takes δ from the carried violations
    as 2‖E‖_F, E = s·RRᵀ − M, a bound ‖E‖_F ≥ ‖E‖₂ ≥ −λ_min(M) that is
    an order of magnitude looser at n ≈ 10³ (ROADMAP F8). None above
    ``ENTRY_EIG_MAX_N`` or when no scaling s exists."""
    import scipy.linalg

    from ..problem import SparseSym, SymLowRank

    n = dp.n
    if n > ENTRY_EIG_MAX_N:
        return None
    R = np.asarray(R_np, dtype=np.float64)[:n]
    w = _wide_w(dp)
    tw = float(np.sum(w * np.sum(R * R, axis=1)))
    if not (np.isfinite(tw) and tw > 0):
        return None
    M = (float(dp.b[int(dp.extra_gids[0])]) / tw) * (R @ R.T)
    rows = dp.entry_rows.cpu().numpy()
    cols = dp.entry_cols.cpu().numpy()
    M[rows, cols] = 0.0
    M[cols, rows] = 0.0
    C = prob.C
    if isinstance(C, SymLowRank):
        lin = float(np.sum(C.d * np.sum(C.B * (M @ C.B), axis=0)))
    elif isinstance(C, SparseSym):
        lin = float(np.sum(C.vals * M[C.rows, C.cols]))
    else:
        return None
    lam_min = float(scipy.linalg.eigh(M, eigvals_only=True,
                                      subset_by_index=[0, 0])[0])
    delta = (max(0.0, -lam_min)
             + 4.0 * n * np.finfo(np.float64).eps * float(np.linalg.norm(M)))
    c = float(dp.entry_mix_c)
    t_mix = delta / (delta + c)
    mix_obj = c * dp.n * float(dp.trC_n)      # ⟨C, c·I⟩, itself feasible
    return min((1.0 - t_mix) * lin + t_mix * mix_obj, mix_obj)


def _feasible_obj(prob, dp, R_np: np.ndarray, vio_raw=None):
    """A feasible objective that certifies the gap from above.

    Entry mode (θ family, ``dp.entry_trace_cert``): the better of the
    PSD-repaired mix (``_entry_eig_cert`` up to n = ENTRY_EIG_MAX_N, else
    the JAX package's ``_entry_mix``, loose at ptol = 1e-2 for n ≳ 10³)
    and the greedy independent-set rounding, which is exactly feasible
    and tight when the factor encodes the optimal support. The state
    machine terminates on ``entry_certified_obj`` instead; this rigorous
    value is what rel_duality_gap reports.

    Identity-diagonal problems (diag(X) = b, b > 0): ⟨C, X̂⟩ for the
    projection R̂ᵢ = Rᵢ·√bᵢ/‖Rᵢ‖, which makes X̂ = R̂R̂ᵀ exactly feasible,
    so dual ≤ p* ≤ ⟨C, X̂⟩. None when no closed form applies."""
    from ..problem import SparseSym, SymLowRank

    if dp.entry_trace_cert and vio_raw is not None:
        cert = _entry_eig_cert(prob, dp, R_np)
        if cert is None:
            lin, mixed, mix_obj = _entry_mix(dp, vio_raw)
            cert = mix_obj if lin is None else mixed
        rounded = _greedy_is_objective(prob, dp, R_np)
        return cert if rounded is None else min(cert, rounded)
    if not dp.diag_identity:
        return None
    b = dp.b.detach().cpu().numpy().astype(np.float64)
    if b.shape[0] != R_np.shape[0] or np.any(b <= 0):
        return None
    norms_sq = np.sum(R_np * R_np, axis=1)
    if np.any(norms_sq <= 0) or not np.all(np.isfinite(norms_sq)):
        return None
    Rhat = R_np * np.sqrt(b / norms_sq)[:, None]
    C = prob.C
    if isinstance(C, SparseSym):
        return float(np.sum(C.vals * np.sum(Rhat[C.rows] * Rhat[C.cols],
                                            axis=1)))
    if isinstance(C, SymLowRank):
        BtR = C.B.T @ Rhat
        return float(np.sum(C.d * np.sum(BtR * BtR, axis=1)))
    return None


def _want_block_lanczos(lanczos_block: int, highprecision: bool,
                        n: int, q_raw: int) -> bool:
    """Block-vs-scalar dual-bound path selection (outer.py:269-285)."""
    if lanczos_block < 0 or highprecision:
        return False
    return lanczos_block > 0 or n > 4096 or min(q_raw, n) > 1024


def _blk_for(lanczos_block: int, highprecision: bool, n: int, r: int,
             q_raw: int = 0) -> tuple:
    """(b, k_max) for the block-Lanczos dual bound, or (0, 0) for the
    scalar path (outer.py:617-633): block for n > 4096, when forced, or
    when the scalar schedule wants more than 1024 steps, so the scalar
    path's 1024-step ceiling never silently shortens a certificate."""
    if not _want_block_lanczos(lanczos_block, highprecision, n, q_raw):
        return 0, 0
    return block_sizes(n, r, max(lanczos_block, 0))


def _engine_name(dp, use_mega: bool) -> str:
    """Which inner-loop engine served this solve (result provenance)."""
    if use_mega:
        return ENGINE_KERNEL if dp.device.type == "cuda" else ENGINE_PLAIN
    if entry_enabled(dp):
        return ENGINE_ENTRY
    if dp.C_dense is not None:
        return ENGINE_TORCH
    return ENGINE_FAST if fast_diag_eligible(dp) else ENGINE_GENERAL


def _final_gap(obj: float, max_dual: float, have_dual) -> float:
    """Relative duality gap of the final iterate against the best
    certified dual bound: (obj - d*)/min(|obj|, |d*|)."""
    if not have_dual:
        return float("inf")
    denom = min(abs(obj), abs(max_dual))
    return (obj - max_dual) / denom if denom > 0 else float("inf")


def sdplr(C, As, b, r: int, *, constraint_types=None,
          config: Optional[SolverConfig] = None, **kwargs) -> dict:
    """Solve min ⟨C,X⟩ s.t. ⟨Aᵢ,X⟩ =/≤ bᵢ, X ⪰ 0 via X = RRᵀ (reference:
    src/sdplr.jl:91-138). Unknown keyword arguments raise. Runs on the
    card unless ``device="cpu"`` is passed."""
    cfg = (config or SolverConfig()).copy_with(**kwargs)
    prob = SDPProblem(C, list(As), np.asarray(b, dtype=np.float64),
                      constraint_types)
    return solve(prob, r, cfg)


def _maybe_rescale_entry(prob: SDPProblem, config: SolverConfig):
    """Conditioning of trace-normalized entry families (Lovász θ: Tr X = 1,
    edge entries 0): solve the equivalent problem in X' = f·X with
    f = Σw/b_w (C' = C/f, b' = f·b; the objective value is unchanged), so
    the entries of X' are O(1) instead of O(1/n). Unscaled, at n = 10³
    the per-step AL progress falls below float32 resolution: the inner
    loop stagnates within a few steps, every boundary takes the
    infeasible branch and σ doubles to the overflow guard. Returns
    (prob', config', f); f = 1.0 means no rescale."""
    from ..problem import SparseSym, SymLowRank

    b = np.asarray(prob.b, dtype=np.float64)
    if prob.constraint_types is not None and np.any(prob.constraint_types):
        return prob, config, 1.0
    nz = np.nonzero(b)[0]
    if len(nz) != 1:
        return prob, config, 1.0
    A_w = prob.As[int(nz[0])]
    if not isinstance(A_w, SparseSym):
        return prob, config, 1.0
    if not ((A_w.rows == A_w.cols).all() and (A_w.vals >= 0).all()):
        return prob, config, 1.0
    b_w = float(b[nz[0]])
    w_sum = float(np.sum(A_w.vals))
    if b_w <= 0 or w_sum <= 0:
        return prob, config, 1.0
    f = w_sum / b_w
    if f < 64.0:
        return prob, config, 1.0
    C = prob.C
    if isinstance(C, SymLowRank):
        C2 = SymLowRank(C.B, C.d / f)
    elif isinstance(C, SparseSym):
        C2 = SparseSym(C.rows, C.cols, C.vals / f, C.n)
    else:
        return prob, config, 1.0
    prob2 = SDPProblem(C2, list(prob.As), b * f, prob.constraint_types)
    tb = config.prior_trace_bound
    cfg2 = config.copy_with(
        prior_trace_bound=tb * f if np.isfinite(tb) else tb)
    return prob2, cfg2, f


def solve(prob: SDPProblem, r: int, config: SolverConfig,
          mesh=None) -> dict:
    """Solve ``prob`` at starting rank ``r`` on ``config.device``. A
    trace-normalized entry family is solved in the rescaled variable
    X' = f·X (``_maybe_rescale_entry``) and its result mapped back:
    R = R'/√f, multipliers y = f·y', ``entry_rescale_f`` = f.

    With ``config.devices > 1`` or a ``mesh`` (parallel/spmd.make_mesh)
    the solve is row-sharded over the mesh's ranks, on the mesh's
    devices: R, G, the L-BFGS history, the ELL, dense-C and mask rows
    sharded, the m-vectors replicated, every reduction summed across
    ranks (JAX package: outer.py:383-430). ``devices`` > 1 without a
    process group starts that many workers (``_spawn_solve``)."""
    nd = int(config.devices)
    if mesh is None and nd > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            return _spawn_solve(prob, r, config)
        from ..parallel.multihost import global_mesh

        mesh = global_mesh()
        if mesh.size != nd:
            raise ValueError(f"devices={nd} but the process group has "
                             f"{mesh.size} rank(s)")
    device = resolve_device(config) if mesh is None else mesh.device
    dtype = resolve_dtype(config)
    if config.printlevel > 0:
        print_heading(True)

    prob, config, rescale_f = _maybe_rescale_entry(prob, config)
    t_pre = time.time()
    if mesh is None:
        cp = compile_problem(prob, dense=config.dense_mode,
                             entry=config.entry_mode)
        dp = to_device(cp, dtype, device)
    else:
        # this rank's problem only (parallel/shardmap.shardmap_problem)
        from ..parallel.shardmap import n_shards_pad, shardmap_problem

        pad = n_shards_pad(mesh.size)
        cp = compile_problem(prob, dense=config.dense_mode,
                             entry=config.entry_mode, n_shards=mesh.size,
                             row_pad=pad, nnz_pad=pad)
        dp = shardmap_problem(cp, dtype, mesh)
    del cp
    preprocess_time = time.time() - t_pre

    result = _profiled(config, lambda: _solve(prob, dp, r, config, dtype))
    result["preprocess_time"] = preprocess_time
    result["totaltime"] += preprocess_time
    result["devices"] = 1 if mesh is None else mesh.size
    if rescale_f != 1.0:
        # back to the user's scale: X = X'/f, so R = R'/√f; S = f·S', so
        # y = f·y'; objective and dual values and relative norms are
        # unchanged by construction
        sf = float(np.sqrt(rescale_f))
        for key in ("R", "Rt", "R0", "Rt0"):
            result[key] = np.asarray(result[key]) / sf
        for key in ("lambda", "lambda_last", "lambda0"):
            result[key] = np.asarray(result[key]) * rescale_f
        result["entry_rescale_f"] = rescale_f
    if config.printlevel > 0:
        print_heading(False)
    return result


def _spawn_solve(prob: SDPProblem, r: int, config: SolverConfig) -> dict:
    """``config.devices`` local workers (torch.multiprocessing, start
    method spawn), one rank each, joined by a ``file://`` rendezvous in a
    temporary directory: NCCL with one card per rank on ``cuda``, gloo on
    the CPU. Returns rank 0's result; a worker's failure raises here.
    Like any spawn, a script that calls this at import time must guard
    its entry point with ``if __name__ == "__main__":``."""
    nd = int(config.devices)
    dev = resolve_device(config)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if nd > have:
            raise ValueError(
                f"devices={nd} on 'cuda' needs {nd} cards (one per NCCL "
                f"rank); this machine has {have}")
        backend = "nccl"
    else:
        backend = "gloo"
    tmp = tempfile.mkdtemp(prefix="sdplr_spawn_")
    try:
        torch.multiprocessing.spawn(
            _solve_worker, args=(nd, backend, dev.type, tmp, prob, r, config),
            nprocs=nd, join=True, start_method="spawn")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _solve_worker(rank: int, nd: int, backend: str, dev_type: str, tmp: str,
                  prob: SDPProblem, r: int, config: SolverConfig):
    """One rank of ``_spawn_solve``: join the group, solve on the mesh,
    rank 0 writes the result."""
    import torch.distributed as dist

    from ..parallel.spmd import make_mesh

    device = torch.device(dev_type, rank) if dev_type == "cuda" \
        else torch.device("cpu")
    if dev_type == "cuda":
        torch.cuda.set_device(device)
    else:   # the host's threads shared among the ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // nd))
    dist.init_process_group(backend,
                            init_method=f"file://{os.path.join(tmp, 'rdv')}",
                            world_size=nd, rank=rank)
    try:
        mesh = make_mesh(nd, device=device)
        cfg = config if rank == 0 else config.copy_with(printlevel=0)
        result = solve(prob, r, cfg, mesh=mesh)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def solve_model(model: CustomModel, r: int,
                config: Optional[SolverConfig] = None, **kwargs) -> dict:
    """Solve an external model (adapter.CustomModel) at starting rank
    ``r`` — the analog of the reference's SolverCore.solve! path
    (reference: src/lowrankopt.jl:33-53). It runs where the model's
    tensors are (the card unless the model was built with
    ``device="cpu"``), in the model's dtype; ``config.device`` and
    ``config.dtype`` are not read. An external model runs on one device:
    ``devices`` > 1 raises."""
    cfg = (config or SolverConfig()).copy_with(**kwargs)
    if int(cfg.devices) > 1:
        raise ValueError("an external model runs on one device; its "
                         "callables cannot be row-sharded (devices must "
                         "be 1)")
    if cfg.printlevel > 0:
        print_heading(True)
    result = _solve(model, model, r, cfg, model.dtype)
    result["preprocess_time"] = 0.0
    result["devices"] = 1
    if cfg.printlevel > 0:
        print_heading(False)
    return result


def _profiled(config: SolverConfig, fn) -> dict:
    """``fn()``, under torch.profiler when ``config.profile_dir`` is set
    (the JAX package's jax.profiler.trace, outer.py:422-425): the host's
    operators and, on the card, its kernels, written into the directory
    as a Chrome trace, whose path the result gives as ``profile_trace``."""
    if config.profile_dir is None:
        return fn()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(config.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(config.profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        result = fn()
    path = os.path.join(config.profile_dir,
                        f"sdplr_trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    result["profile_trace"] = path
    return result


def _has_inequalities(prob) -> bool:
    """Whether the problem has inequality constraints. The JAX package
    reads ``prob.constraint_types`` here, which an external model lacks
    (ROADMAP F1); the model says so itself."""
    if isinstance(prob, CustomModel):
        return prob.has_inequalities
    ct = prob.constraint_types
    return ct is not None and bool(np.any(ct))


def _solve(prob, dp, r: int, config: SolverConfig, dtype) -> dict:
    """The fused driver (or the host-driven loop), the host f64 dual
    polish and the reseed ladder. On the rank-local problem of a sharded
    solve (``dp.spmd``) the fused driver's result and the polish are
    rank 0's, broadcast, so every rank takes the same decisions after
    them."""
    mesh = dp.spmd
    if mesh is not None and not config.fused_outer:
        raise ValueError(
            "multi-device solves run through the fused outer driver; "
            "set fused_outer=True (the default) when devices > 1")
    if not config.fused_outer:
        return _solve_host(prob, dp, r, config, dtype)

    def agreed(fn, res=None):
        # fn(res) on rank 0 only, its result on every rank
        if mesh is None:
            return fn(res)
        from ..parallel.comm import broadcast_obj

        return broadcast_obj(fn(res) if mesh.rank == 0 else None, mesh)

    def fused(cfg):
        res = _solve_fused(prob, dp, r, cfg, dtype)
        return res if mesh is None else agreed(lambda _: res)

    result = fused(config)

    def _gap_of(res):
        g = res.get("rel_duality_gap")
        return float("inf") if g is None or not np.isfinite(g) else float(g)

    def _dual_polish(res):
        # host f64 dual polish (solver/dualrefine.refine_dual): when the
        # certificate misses the tolerance the slack is in the dual
        # multiplier; any y certifies by weak duality, so maximizing d(y)
        # in float64 can only tighten the reported bound
        # it reads C and the Aᵢ on the host, which an external model has
        # only as callables
        gap_now = _gap_of(res)
        if not (isinstance(prob, SDPProblem) and not _has_inequalities(prob)
                and np.isfinite(config.objtol)
                and config.objtol > 0
                and np.isfinite(gap_now) and gap_now > config.objtol
                and res.get("lambda") is not None
                and config.maxtime - float(res["totaltime"]) > 30.0):
            return res
        from .dualrefine import refine_dual

        t_ref = time.time()
        b64 = np.asarray(prob.b, np.float64)
        try:
            y_ref, dual_ref, _, _ = refine_dual(
                prob.C, prob.As, b64, -np.asarray(res["lambda"], np.float64),
                float(config.prior_trace_bound), iters=6,
                k_eig=min(96, max(8, prob.n - 2)),
                verbose=config.printlevel > 1)
            obj_c = res.get("obj_feasible")
            obj_c = float(res["obj"]) if obj_c is None else float(obj_c)
            if (_final_gap(obj_c, dual_ref, True) > config.objtol
                    and config.maxtime - float(res["totaltime"])
                    - (time.time() - t_ref) > 60.0):
                # escalate once: wider eigenband + deeper LSQR
                y2, d2, _, _ = refine_dual(
                    prob.C, prob.As, b64, y_ref,
                    float(config.prior_trace_bound), iters=10,
                    k_eig=min(160, max(8, prob.n - 2)), lsqr_iters=300,
                    verbose=config.printlevel > 1)
                if d2 > dual_ref:
                    y_ref, dual_ref = y2, d2
            if dual_ref > float(res["max_dual_value"]):
                gap_ref = _final_gap(obj_c, dual_ref, True)
                res["max_dual_value"] = float(dual_ref)
                res["lambda"] = -y_ref
                res["rel_duality_gap"] = gap_ref
                res["min_duality_gap"] = min(float(res["min_duality_gap"]),
                                             gap_ref)
                res["dual_refined"] = True
                if config.printlevel > 0:
                    print(f"host f64 dual polish: gap {gap_now:.3e} -> "
                          f"{gap_ref:.3e} ({time.time() - t_ref:.1f} s)")
            res["dual_refine_time"] = time.time() - t_ref
            res["totaltime"] += res["dual_refine_time"]
        except Exception as e:
            # best effort, as in the JAX package: the solve's own
            # certificate stands (ARPACK refuses n < 3, for one)
            res["dual_refine_error"] = f"{type(e).__name__}: {e}"
        return res

    result = agreed(_dual_polish, result)
    spent = float(result["totaltime"])
    # reseed-restart, the last rung of the stall ladder: a trajectory can
    # land in a spurious basin; while wall-clock remains, retry from a
    # fresh seed and keep the best attempt
    attempts = 0
    while (attempts < 2
           and np.isfinite(config.objtol) and config.objtol > 0
           and not result.get("timed_out", False)
           and _gap_of(result) > config.objtol
           and config.maxtime - spent > max(60.0, 0.2 * spent)):
        attempts += 1
        cfg2 = config.copy_with(seed=config.seed + 1031 * attempts,
                                maxtime=config.maxtime - spent)
        if config.printlevel > 0:
            print(f"certificate unusable (gap {_gap_of(result):.3g}) with "
                  f"budgets exhausted; reseed-restart {attempts} "
                  f"(seed {cfg2.seed}).")
        res2 = fused(cfg2)
        spent += float(res2["totaltime"])
        if _gap_of(res2) < _gap_of(result):
            result = res2
        result["totaltime"] = spent
        result["reseed_attempts"] = attempts
    return agreed(_dual_polish, result)


def _solve_fused(prob, dp: DeviceProblem, r: int, config: SolverConfig,
                 dtype) -> dict:
    """Each call of major_chunk runs up to ``inner_chunk`` inner steps and
    every major-iteration boundary it crosses; the host checks limits,
    prints, and re-specializes shapes on rank doubling. On the rank-local
    problem of a sharded solve (``dp.spmd``) each call is the mesh's
    program (parallel/shardmap.make_shardmap_major) and R, G, CX and the
    L-BFGS history stay this rank's rows; ``dp_full`` gathers the factor
    where the whole is read."""
    from ..ops.megakernel import mega_spec_for, megakernel_eligible
    from ..parallel.comm import clock as mesh_clock
    from ..parallel.comm import dp_full, local_rows, n_loc
    from ..parallel.shardmap import engine_suffix, make_shardmap_major
    from .major import init_major_carry, major_chunk

    n, m = dp.n, dp.m
    rng = np.random.default_rng(config.seed)
    gen = torch.Generator().manual_seed(int(config.seed))
    mesh = dp.spmd
    clock = lambda: mesh_clock(mesh)

    def run_chunk(carry, *args, mega_data, entry_graphs, mega_kw, **kw):
        if mesh is None:
            return major_chunk(dp, carry, *args, mega_data, **kw,
                               entry_graphs=entry_graphs, **mega_kw)
        return make_shardmap_major(mesh, dp, **kw)(
            dp, carry, *args, entry_graphs=entry_graphs)

    starttime = clock()
    lastprint = starttime

    R, lam = _init_vars(prob, dp, r, config, dtype, rng)
    R0_np = R[:n].cpu().numpy()
    lam0_np = lam.cpu().numpy()
    R = local_rows(dp, R)

    k = int(config.numlbfgsvecs)
    use_armijo = dp.has_inequalities
    gtol_rel = config.gtol_mode == "relative"
    ptol_rel = config.ptol_mode == "relative"
    objtol_rel = config.objtol_mode == "relative"
    stag_tol = _stagnation_tol(config, dtype)
    sigma0 = float(config.sigma0)

    mega_meta, mega_data = _mega_setup(dp, r, k, use_armijo, dtype, config)

    def blk_for(r_now: int, q_raw: int = 0) -> tuple:
        return _blk_for(config.lanczos_block, config.eigval_highprecision,
                        n, r_now, q_raw)

    def mega_kwargs(r_now: int) -> dict:
        if mega_meta is None or not megakernel_eligible(
                dp, r_now, k, use_armijo, dtype):
            return {}
        return {"mega_spec": mega_spec_for(mega_meta, r_now),
                "mega_r": r_now}

    def cx_for(r_now: int) -> bool:
        # the carry holds CX exactly when major_chunk runs the torch inner
        # loop on a fast-diagonal problem (solver/major.py use_cx)
        return not mega_kwargs(r_now) and fast_diag_eligible(dp)

    def fresh_carry(R, lam):
        return init_major_carry(
            dp, R, lam, sigma0, max(1.0 / sigma0 ** 0.1, config.ptol),
            max(1.0 / sigma0, _gtol_floor(config, dtype)), gen,
            lbfgs_init(k, n_loc(dp), r, dtype, dp.device),
            config.rankupd_tol,
            gtol_relative=gtol_rel, ptol_relative=ptol_rel,
            with_cx=cx_for(r))

    carry = fresh_carry(R, lam)
    base_total = 0   # inner steps before the current carry lifetime
    base_major = 0   # major boundaries before the current lifetime
    q_boost = 1      # Lanczos budget escalation once r hits the BP cap
    tried_polish = False       # one bounded stagnation-off attempt per rank
    saved_stag_tol = stag_tol
    polish_start = 0
    POLISH_BUDGET = 1500       # inner steps a polish may spend
    final_polish = False       # permanent stagnation-off at the ladder end
    timed_out = False
    entry_graphs = EntryGraphs()   # the entry step's CUDA graph, this solve
    vio_norm = float("inf")

    # adaptive per-call step budget (config.dispatch_target_s); small
    # problems run full chunks
    adapt = config.dispatch_target_s > 0 and dp.n_pad > 4096
    chunk_now = min(config.inner_chunk, 250) if adapt else config.inner_chunk
    gtol_floor = _gtol_floor(config, dtype)
    # minimum block-Krylov depth ~ log2(n) (outer.py:745-747)
    k_min_base = max(4, int(np.ceil(np.log2(max(n, 2)))))

    while True:
        steps_now = carry.ic.steps
        majors_now = carry.majoriters
        total_iter = base_total + steps_now
        majoriter = base_major + majors_now

        chunk = min(chunk_now, config.maxiter - total_iter + 1)
        major_thresh = config.maxmajoriter - base_major
        if chunk <= 0:
            print("Warning: iteration limit exceeded. Stop optimizing.")
            break
        if majors_now >= major_thresh:
            print("Warning: major iteration limit exceeded. Stop optimizing.")
            break

        q_raw = lanczos_q(total_iter + chunk, n) * q_boost
        if config.eigval_highprecision:
            q_raw = min(max(100, 2 * q_raw), n)
        blk = blk_for(r, q_raw)
        # the scalar path's 1024-step ceiling; a schedule that wants more
        # has escalated to the block path in blk_for (outer.py:739)
        q_need = min(q_raw, max(n, 1), 1024)
        q_max = bucket_q_max(q_need)
        # gap-stall escalation (q_boost) demands a deeper minimum Krylov
        # depth and a tighter margin (outer.py:745-747)
        blk_margin_frac = 0.25 / q_boost
        blk_k_min = min(k_min_base * q_boost, blk[1]) if blk[0] else 4
        # major boundaries per dispatch, sized to the boundary's cost: a
        # block bound is a few dozen passes, a scalar one up to 1024
        dispatch_majors = (
            min(major_thresh, majors_now + (8 if blk[0] else 2))
            if adapt else major_thresh)
        t_dispatch = clock()
        carry, vio_norm_d = run_chunk(
            carry, steps_now + chunk, dispatch_majors, base_total,
            stag_tol, config.ptol, gtol_floor, config.objtol,
            config.sigmafac, config.prior_trace_bound, config.rankupd_tol,
            mega_data=mega_data, entry_graphs=entry_graphs,
            mega_kw=mega_kwargs(r), k=k, use_armijo=use_armijo,
            gtol_relative=gtol_rel, ptol_relative=ptol_rel,
            objtol_relative=objtol_rel, q_max=q_max,
            highprecision=bool(config.eigval_highprecision),
            dual_safeguard=bool(config.dual_safeguard),
            lbfgs_compact=config.lbfgs_impl == "compact",
            blk_b=blk[0], blk_kmax=blk[1],
            blk_margin_frac=blk_margin_frac, blk_k_min=blk_k_min)
        new_steps = carry.ic.steps
        new_majors = carry.majoriters
        vio_norm = float(vio_norm_d)
        now = clock()
        if adapt:
            dt = max(now - t_dispatch, 1e-3)
            rate = max(new_steps - steps_now, 1) / dt
            chunk_now = int(min(max(rate * config.dispatch_target_s, 64),
                                config.inner_chunk))
        total_iter = base_total + new_steps
        majoriter = base_major + new_majors

        if config.printlevel > 0 and (
                now - lastprint >= config.printfreq or carry.converged):
            lastprint = now
            print_intermediate(
                config.dataset, majoriter, new_steps, total_iter,
                float(carry.ic.L_val), float(carry.ic.vio_raw[m]),
                float(carry.sigma), float(carry.cur_gtol),
                float(carry.cur_ptol), float(carry.ic.grad_norm), vio_norm,
                float(carry.min_gap), float(carry.max_dual),
            )

        # the state at this call's last major boundary (outer.py:830-838);
        # rank 0 writes the full factor of a sharded solve
        if config.checkpoint_path is not None:
            R_full = dp_full(dp, carry.ic.R)
            if mesh is None or mesh.rank == 0:
                save_checkpoint(
                    config.checkpoint_path, R=R_full[:n].cpu().numpy(),
                    lam=carry.lam.cpu().numpy(), sigma=float(carry.sigma),
                    r=r, majoriter=majoriter, total_iter=total_iter)

        if carry.converged:
            break
        if final_polish and new_majors == majors_now:
            # pull cur_gtol just below the gradient norm so the next call
            # crosses a boundary and re-certifies (the stagnation break is
            # off in the final polish)
            carry.cur_gtol = torch.clamp(carry.ic.grad_norm * 0.9,
                                         min=gtol_floor)
        if (tried_polish and not final_polish and stag_tol == -np.inf
                and total_iter - polish_start > POLISH_BUDGET):
            stag_tol = saved_stag_tol
        if carry.rank_double:
            # before doubling the rank, one bounded polish (stagnation
            # break off) at the current rank: stagnation-deadlock stalls
            # are fixed by the polish alone
            if stag_tol > -np.inf and not tried_polish:
                tried_polish = True
                saved_stag_tol = stag_tol
                stag_tol = -np.inf
                polish_start = total_iter
                if config.printlevel > 0:
                    print("stagnation-deadlock stall; disabling the "
                          "stagnation break (bounded polish) before "
                          "rank doubling.")
                carry.rank_double = False
                carry.rankupd_cnt = config.rankupd_tol
                carry.ic.stagnated = False
                continue
            if tried_polish and stag_tol == -np.inf:
                stag_tol = saved_stag_tol
            r_new = next_rank(r, n, m)
            if r_new == r:
                # at the Barvinok–Pataki cap: escalate the Lanczos budget
                if q_boost >= 64:
                    if not final_polish:
                        final_polish = True
                        stag_tol = -np.inf
                        if config.printlevel > 0:
                            print("all budgets maxed; final polish phase "
                                  "(stagnation break off).")
                        carry.rank_double = False
                        carry.rankupd_cnt = config.rankupd_tol
                        carry.ic.stagnated = False
                        continue
                    print("Warning: duality gap stalled with rank at the "
                          "Barvinok-Pataki cap and the Lanczos budget "
                          "exhausted. Stop optimizing.")
                    break
                q_boost = min(q_boost * 2, 64)
                if config.printlevel > 0:
                    print(f"rank at Barvinok-Pataki cap {r}; "
                          f"raising Lanczos budget x{q_boost}.")
                carry.rank_double = False
                carry.rankupd_cnt = config.rankupd_tol
                continue
            base_total = total_iter
            base_major = majoriter
            r = r_new
            tried_polish = False
            if config.printlevel > 0:
                print(f"rank doubled, new rank is {r}.")
            if config.rank_update_mode == "warm" and config.init_func is None:
                R = local_rows(dp, _warm_vars(dp, dp_full(dp, carry.ic.R),
                                              r, rng, dtype))
                newc = init_major_carry(
                    dp, R, carry.lam, float(carry.sigma),
                    float(carry.cur_ptol), float(carry.cur_gtol), gen,
                    lbfgs_init(k, n_loc(dp), r, dtype, dp.device),
                    config.rankupd_tol,
                    gtol_relative=gtol_rel, ptol_relative=ptol_rel,
                    with_cx=cx_for(r))
                # dual values and the gap history stay valid across ranks
                carry = dataclasses.replace(
                    newc, best_lam=carry.best_lam, max_dual=carry.max_dual,
                    min_gap=carry.min_gap)
            else:
                R, lam = _init_vars(prob, dp, r, config, dtype, rng)
                carry = fresh_carry(local_rows(dp, R), lam)
            continue
        if now - starttime > config.maxtime:
            print("Warning: time limit exceeded. Stop optimizing.")
            timed_out = True
            break
        if total_iter > config.maxiter:
            print("Warning: iteration limit exceeded. Stop optimizing.")
            break
        if new_steps == steps_now and new_majors == majors_now:
            print("Warning: no progress in fused dispatch. Stop optimizing.")
            break

    totaltime = clock() - starttime
    R, lam, vio_raw = carry.ic.R, carry.lam, carry.ic.vio_raw
    grad_norm = float(carry.ic.grad_norm)
    max_dual_f = float(carry.max_dual)
    best_lam_np = carry.best_lam.cpu().numpy().astype(np.float64)
    feas = carry.feas_count
    extra_dual_passes = 0
    if feas == 0 and config.objtol != np.inf and m > 0:
        # the run never reached a strict boundary (timeout / maxiter /
        # stall): still report a (weak) dual bound from the final iterate
        blk_f = blk_for(r)
        obj_now = abs(float(vio_raw[m]))
        mt_f = 0.25 * config.objtol * (
            max(obj_now, 1e-8) if objtol_rel else 1.0
        ) / max(config.prior_trace_bound, 1.0)
        dv, _, y_d = dual_obj(
            dp, lam, carry.sigma, vio_raw, config.prior_trace_bound,
            max(base_total + carry.ic.steps, 1), gen,
            highprecision=config.eigval_highprecision,
            safeguard=config.dual_safeguard,
            block=blk_f if blk_f[0] else None, margin_target=mt_f,
            R_seed=R, k_min=min(k_min_base, blk_f[1]))
        if float(dv) > max_dual_f:
            max_dual_f = float(dv)
            best_lam_np = -y_d[:m].cpu().numpy().astype(np.float64)
        feas = 1
        extra_dual_passes = blk_f[1] if blk_f[0] else 1024

    # dual-time attribution from the measured operator-pass count
    # (outer.py:1013-1049): on the gather-bound engines a Krylov pass of
    # any lane count costs one ELL SpMM, and an inner iteration one SpMM
    # (fast-diagonal) or three passes (general: the [R|D] gather of the
    # line search and the gradient's SpMM, counted as the JAX package's
    # two line-search products and one adjoint); on the matmul-bound
    # engines (dense, megakernels, entry-mask) an inner iteration costs
    # ~3·r units and a Krylov pass its lane count (b or 1)
    dual_time = 0.0
    total_steps = base_total + carry.ic.steps
    dual_passes = carry.dual_passes + extra_dual_passes
    if dual_passes > 0 and total_steps > 0:
        engine = _engine_name(dp, bool(mega_kwargs(r)))
        if engine in (ENGINE_FAST, ENGINE_GENERAL):
            dual_units = float(dual_passes)
            primal_units = (1.0 if engine == ENGINE_FAST else 3.0) \
                * float(total_steps)
        else:
            lanes = max(blk_for(r)[0], 1)
            dual_units = float(dual_passes) * float(lanes)
            primal_units = 3.0 * float(max(r, 1)) * float(total_steps)
        frac = dual_units / max(dual_units + primal_units, 1e-30)
        dual_time = min(max(frac * totaltime, 0.0), totaltime)

    t_dimacs = time.time()
    if config.eval_DIMACS_errs:
        DIMACS_errs = dimacs_errors(dp, R, lam, vio_raw, vio_raw[m], gen)
    else:
        DIMACS_errs = np.zeros(6)
    dimacs_time = time.time() - t_dimacs

    obj = float(vio_raw[m])
    R_np = dp_full(dp, R)[:n].cpu().numpy().astype(np.float64)
    obj_feas = _feasible_obj(prob, dp, R_np, vio_raw.cpu().numpy())
    final_gap = _final_gap(obj if obj_feas is None else obj_feas,
                           max_dual_f, feas)
    return {
        "R": R_np,
        "Rt": R_np.T,
        "lambda": best_lam_np,
        "lambda_last": lam.cpu().numpy().astype(np.float64),
        "R0": R0_np,
        "Rt0": R0_np.T,
        "lambda0": lam0_np,
        "sigma": float(carry.sigma),
        "grad_norm": grad_norm,
        "primal_vio": vio_norm,
        "obj": obj,
        "max_dual_value": max_dual_f,
        "min_duality_gap": float(carry.min_gap),
        "rel_duality_gap": final_gap,
        "obj_feasible": obj_feas,
        "duality_gap": float(carry.last_gap),
        "totaltime": totaltime,
        "dual_time": dual_time,
        "dual_time_estimated": True,  # measured passes × modeled unit cost
        "dual_passes": dual_passes,
        "dual_lanczos_time": dual_time,
        "primaltime": totaltime - dual_time,
        "DIMACS_time": dimacs_time,
        "iter": total_steps,
        "majoriter": base_major + carry.majoriters,
        "dual_bounds_computed": feas,
        "DIMACS_errs": np.asarray(DIMACS_errs),
        "ptol": config.ptol,
        "objtol": config.objtol,
        "fprec": config.fprec,
        "rankupd_tol": config.rankupd_tol,
        "r": r,
        "timed_out": timed_out,
        "inner_engine": _engine_name(dp, bool(mega_kwargs(r))) + (
            "" if mesh is None else engine_suffix(dp)),
        "dtype": str(dtype).replace("torch.", ""),
    }


def _mega_setup(dp, r: int, k: int, use_armijo: bool, dtype,
                config: SolverConfig):
    """The megakernel's host-side data for both drivers, or (None, None)
    for the torch inner loop (outer.py:607-615, :1137-1149): 'auto' takes
    a megakernel (K1 for equality problems, K2 for inequalities) on CUDA
    when eligible; 'mega' takes it on CUDA and its plain version on the
    CPU, and raises when the problem is not eligible; 'xla' takes the
    torch inner loop."""
    from ..ops.megakernel import megakernel_eligible, prepare_mega_data

    if config.inner_impl not in ("auto", "mega"):
        return None, None
    eligible = megakernel_eligible(dp, r, k, use_armijo, dtype)
    if config.inner_impl == "mega" and not eligible:
        raise ValueError(
            "inner_impl='mega' requested but the problem is not "
            "megakernel-eligible (needs every constraint entry on the "
            "diagonal with one entry per narrow constraint; K1 also "
            "needs dense C and equality constraints only, K2 at most "
            "4 channels per row and 2 wide constraints; plus the "
            "layout limits of ops/megakernel.py)")
    if config.inner_impl == "auto" and dp.device.type != "cuda":
        return None, None
    if not eligible:
        return None, None
    return prepare_mega_data(dp, k=k, gtol_relative=config.gtol_mode
                             == "relative",
                             ptol_relative=config.ptol_mode == "relative")


def _solve_host(prob, dp, r: int, config: SolverConfig, dtype) -> dict:
    """The host-driven loop, ``fused_outer=False`` (outer.py:1110-1462):
    the host runs each major iteration, calling the inner loop in chunks
    of up to ``inner_chunk`` steps (K1 or K2 through ``mega_run_for`` when
    eligible on the card, the entry chunk in entry mode, else the torch
    inner loop) and reading the state after each chunk; then, at the
    boundary, the dual bound (at strict boundaries), the gap, dual ascent
    or the penalty update, rank doubling, the checkpoint and the fg!
    re-sync. The same mathematics as the fused driver, which the tests
    hold it against."""
    from ..ops.megakernel import mega_chunk, mega_spec_for, megakernel_eligible

    n, m = dp.n, dp.m
    rng = np.random.default_rng(config.seed)
    gen = torch.Generator().manual_seed(int(config.seed))
    dev = dp.device
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)

    starttime = time.time()
    lastprint = starttime

    R, lam = _init_vars(prob, dp, r, config, dtype, rng)
    R0_np, lam0_np = R[:n].cpu().numpy(), lam.cpu().numpy()
    sigma = float(config.sigma0)

    k = int(config.numlbfgsvecs)
    use_armijo = dp.has_inequalities
    gtol_rel = config.gtol_mode == "relative"
    ptol_rel = config.ptol_mode == "relative"
    objtol_rel = config.objtol_mode == "relative"
    lbfgs_compact = config.lbfgs_impl == "compact"
    stag_tol = _stagnation_tol(config, dtype)
    pscale = dp.normb if ptol_rel else 1.0
    lbfgs = lbfgs_init(k, dp.n_pad, r, dtype, dev)
    entry_graphs = EntryGraphs()
    # minimum block-Krylov depth ~ log2(n), as the JAX package's dual_obj
    # takes it (dualbound.py:247)
    k_min_base = max(4, int(np.ceil(np.log2(max(n, 2)))))

    mega_meta, mega_data = _mega_setup(dp, r, k, use_armijo, dtype, config)
    mega_specs = {}

    def mega_run_for(r_now: int):
        """The megakernel's spec for the current rank, or None (the torch
        or entry inner loop): the rank may grow past its layout."""
        if mega_meta is None:
            return None
        if r_now not in mega_specs:
            if not megakernel_eligible(dp, r_now, k, use_armijo, dtype):
                return None
            mega_specs[r_now] = mega_spec_for(mega_meta, r_now)
        return mega_specs[r_now]

    def fg():
        L, v, G_, y, gn, pn = al_value_grad(dp, R, lam, t(sigma), gtol_rel,
                                            ptol_rel)
        return L, v, G_, y, float(gn), float(pn)

    cur_gtol = max(1.0 / sigma, _gtol_floor(config, dtype))
    cur_ptol = max(1.0 / sigma ** 0.1, config.ptol)
    L_val, vio_raw, G, y_full, grad_norm, vio_norm = fg()

    total_iter = 0
    majoriter = 0
    dual_time = 0.0
    dual_count = 0
    dual_passes = 0
    duality_gap = 1e20
    min_duality_gap = 1e20
    max_dual_value = -1e20
    best_lam = lam.cpu().numpy().astype(np.float64)
    rankupd_cnt = config.rankupd_tol

    def maybe_print(localiter, force=False):
        nonlocal lastprint
        now = time.time()
        if force or now - lastprint >= config.printfreq:
            lastprint = now
            if config.printlevel > 0:
                print_intermediate(
                    config.dataset, majoriter, localiter, total_iter,
                    float(L_val), float(vio_raw[m]), sigma, cur_gtol,
                    cur_ptol, grad_norm, vio_norm, min_duality_gap,
                    max_dual_value)

    timed_out = False
    for _ in range(config.maxmajoriter):
        majoriter += 1
        localiter = 0

        # the inner loop in chunks (reference: src/sdplr.jl:190-278)
        while grad_norm > cur_gtol:
            steps = min(config.inner_chunk, config.maxiter - total_iter + 1)
            if steps <= 0:
                break
            spec = mega_run_for(r)
            if spec is not None:
                c, pnorm = mega_chunk(spec, r, m, pscale, mega_data, R, lbfgs,
                                      lam, t(sigma), t(cur_gtol),
                                      t(stag_tol), steps)
            elif entry_enabled(dp):
                c, pnorm = entry_chunk(
                    dp, R, G, vio_raw, L_val, t(grad_norm), lbfgs, lam,
                    t(sigma), t(cur_gtol), t(stag_tol), steps, k=k,
                    gtol_relative=gtol_rel, ptol_relative=ptol_rel,
                    lbfgs_compact=lbfgs_compact, graphs=entry_graphs)
            else:
                c, pnorm = inner_chunk(
                    dp, R, G, y_full, vio_raw, L_val, t(grad_norm), lbfgs,
                    lam, t(sigma), t(cur_gtol), t(stag_tol), steps, k=k,
                    use_armijo=use_armijo, gtol_relative=gtol_rel,
                    ptol_relative=ptol_rel, lbfgs_compact=lbfgs_compact)
            R, G, y_full, vio_raw, L_val = c.R, c.G, c.y_full, c.vio_raw, \
                c.L_val
            lbfgs = c.lbfgs
            localiter += int(c.steps)
            total_iter += int(c.steps)
            grad_norm = float(c.grad_norm)
            vio_norm = float(pnorm)
            maybe_print(localiter)
            if bool(c.stagnated):
                break
            if (time.time() - starttime > config.maxtime
                    or total_iter > config.maxiter):
                break

        maybe_print(localiter, force=True)

        if time.time() - starttime > config.maxtime:
            print("Warning: time limit exceeded. Stop optimizing.")
            timed_out = True
            break
        if total_iter > config.maxiter:
            print("Warning: iteration limit exceeded. Stop optimizing.")
            break

        rank_double = False
        converged = False

        if vio_norm <= cur_ptol:
            # the dual bound at strict boundaries only (src/sdplr.jl:310-
            # 357), the multiplier alternating between the least-squares
            # estimate (R passed) and the AL ascent iterate, as in the
            # fused driver (solver/major.py dual_bound)
            t_dual = time.time()
            if vio_norm <= config.ptol:
                blk = (0, 0)
                if (config.lanczos_block >= 0
                        and not config.eigval_highprecision
                        and (config.lanczos_block > 0 or n > 4096)):
                    blk = block_sizes(n, r, max(config.lanczos_block, 0))
                obj_now = abs(float(vio_raw[m]))
                mt = 0.25 * config.objtol * (
                    max(obj_now, 1e-8) if objtol_rel else 1.0
                ) / max(config.prior_trace_bound, 1.0)
                stats = {}
                dual_value, _, y_dual = dual_obj(
                    dp, lam, t(sigma), vio_raw, config.prior_trace_bound,
                    max(total_iter, 1), gen,
                    highprecision=config.eigval_highprecision,
                    safeguard=config.dual_safeguard,
                    R=R if dual_count % 2 == 0 else None,
                    block=blk if blk[0] else None, margin_target=mt,
                    R_seed=R, k_min=min(k_min_base, blk[1]) if blk[0] else 4,
                    stats=stats)
                dual_count += 1
                dual_passes += stats["passes"]
            else:
                dual_value = -np.inf
            dual_time += time.time() - t_dual

            if dual_value > max_dual_value:
                best_lam = -y_dual[:m].cpu().numpy().astype(np.float64)
                max_dual_value = dual_value
            # the termination objective is the certificate the result
            # reports: the feasibility-projected or entry-certified value
            obj = float(vio_raw[m])
            if vio_norm <= config.ptol:
                if dp.entry_trace_cert:
                    obj = _entry_term_obj(dp, vio_raw.cpu().numpy(),
                                          config.objtol, objtol_rel)
                else:
                    obj_cert = _feasible_obj(
                        prob, dp, R[:n].cpu().numpy().astype(np.float64),
                        vio_raw.cpu().numpy())
                    if obj_cert is not None and np.isfinite(obj_cert):
                        obj = float(obj_cert)
            if objtol_rel:
                denom = min(abs(obj), abs(max_dual_value))
                duality_gap = ((obj - max_dual_value) / denom if denom > 0
                               else np.inf)
            else:
                duality_gap = obj - max_dual_value

            if vio_norm <= config.ptol:
                if config.objtol == np.inf:
                    converged = True
                elif duality_gap <= config.objtol:
                    min_duality_gap = min(min_duality_gap, duality_gap)
                    converged = True
                else:
                    if min_duality_gap - duality_gap < config.objtol:
                        rankupd_cnt -= 1
                    else:
                        rankupd_cnt = config.rankupd_tol
                    min_duality_gap = min(min_duality_gap, duality_gap)
                    if rankupd_cnt == 0:
                        rank_double = True
            if converged:
                break

            # dual ascent λ ← min(λ_ub, λ − σv) (src/sdplr.jl:358-364)
            lam = torch.minimum(dp.lam_ub, lam - t(sigma) * vio_raw[:m])
            cur_ptol = cur_ptol / sigma ** 0.9
            cur_gtol = cur_gtol / sigma
        else:
            # infeasible: tighten the penalty (src/sdplr.jl:365-370)
            sigma *= config.sigmafac
            cur_ptol = 1.0 / sigma ** 0.1
            cur_gtol = 1.0 / sigma

        # rank doubling (src/sdplr.jl:372-386)
        if rank_double:
            r = next_rank(r, n, m)
            if config.rank_update_mode == "warm" and config.init_func is None:
                R = _warm_vars(dp, R, r, rng, dtype)
            else:
                R, lam = _init_vars(prob, dp, r, config, dtype, rng)
                sigma = float(config.sigma0)
                cur_ptol = 1.0 / sigma ** 0.1
                cur_gtol = 1.0 / sigma
                min_duality_gap = 1e20
                max_dual_value = -1e20
            lbfgs = lbfgs_init(k, dp.n_pad, r, dtype, dev)
            rankupd_cnt = config.rankupd_tol
            if config.printlevel > 0:
                print(f"rank doubled, new rank is {r}.")
        else:
            lbfgs = lbfgs_clear(lbfgs)

        cur_ptol = max(cur_ptol, config.ptol)
        cur_gtol = max(cur_gtol, _gtol_floor(config, dtype))

        # checkpoint at the major boundary (outer.py:1377-1390)
        if (config.checkpoint_path is not None
                and majoriter % max(config.checkpoint_every, 1) == 0):
            save_checkpoint(
                config.checkpoint_path, R=R[:n].cpu().numpy(),
                lam=lam.cpu().numpy(), sigma=sigma, r=r, majoriter=majoriter,
                total_iter=total_iter)

        # re-sync for the next major iteration (src/sdplr.jl:389)
        L_val, vio_raw, G, y_full, grad_norm, vio_norm = fg()

        if majoriter == config.maxmajoriter:
            print("Warning: major iteration limit exceeded. Stop optimizing.")

    # final re-sync and report (src/sdplr.jl:396-425)
    L_val, vio_raw, G, y_full, grad_norm, vio_norm = fg()
    maybe_print(-1, force=True)

    totaltime = time.time() - starttime
    t_dimacs = time.time()
    if config.eval_DIMACS_errs:
        DIMACS_errs = dimacs_errors(dp, R, lam, vio_raw, vio_raw[m], gen)
    else:
        DIMACS_errs = np.zeros(6)
    dimacs_time = time.time() - t_dimacs

    obj = float(vio_raw[m])
    R_np = R[:n].cpu().numpy().astype(np.float64)
    obj_feas = _feasible_obj(prob, dp, R_np, vio_raw.cpu().numpy())
    rel_gap = _final_gap(obj if obj_feas is None else obj_feas,
                         max_dual_value, max_dual_value > -1e19)
    return {
        "R": R_np,
        "Rt": R_np.T,
        "lambda": best_lam,
        "lambda_last": lam.cpu().numpy().astype(np.float64),
        "R0": R0_np,
        "Rt0": R0_np.T,
        "lambda0": lam0_np,
        "sigma": sigma,
        "grad_norm": grad_norm,
        "primal_vio": vio_norm,
        "obj": obj,
        "max_dual_value": max_dual_value,
        "min_duality_gap": min_duality_gap,
        "rel_duality_gap": rel_gap,
        "obj_feasible": obj_feas,
        "duality_gap": duality_gap,
        "totaltime": totaltime,
        "dual_time": dual_time,
        "dual_time_estimated": False,  # measured on the host's clock
        "dual_passes": dual_passes,
        "dual_lanczos_time": dual_time,
        "primaltime": totaltime - dual_time,
        "DIMACS_time": dimacs_time,
        "iter": total_iter,
        "majoriter": majoriter,
        "dual_bounds_computed": dual_count,
        "DIMACS_errs": np.asarray(DIMACS_errs),
        "ptol": config.ptol,
        "objtol": config.objtol,
        "fprec": config.fprec,
        "rankupd_tol": config.rankupd_tol,
        "r": r,
        "timed_out": timed_out,
        "inner_engine": _engine_name(dp, mega_run_for(r) is not None),
        "dtype": str(dtype).replace("torch.", ""),
    }
