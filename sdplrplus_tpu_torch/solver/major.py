"""The outer driver's state machine: many major AL iterations per call.

Counterpart of the JAX package's ``solver/major.py`` (reference:
src/sdplr.jl:185-393). The JAX package fuses the whole major-iteration
state machine into one ``lax.while_loop``; here it is a Python loop with
the same exits and the same two-way body, each body a whole inner
activation or one major boundary, picked on one host read of the state:

  * inner L-BFGS steps: one activation of the torch loop
    (solver/inner.run_activation: chunks of K masked steps on the device,
    a CUDA graph on the card, one host read per chunk; on the
    fast-diagonal engine with the carried CX = C@R), or one launch of a
    CUDA megakernel (ops/megakernel.mega_chunk: K1 for equality
    problems, K2 for the inequality families), or in entry mode (Lovász
    θ) one call of the dense-mask loop (solver/inner_entry.entry_chunk);
  * the feasibility branch: vio ≤ cur_ptol → at strict boundaries the
    Lanczos dual bound (least-squares and AL multipliers alternating; in
    entry mode on S assembled densely once per bound),
    best-λ/gap tracking, dual ascent and tolerance tightening
    (reference: src/sdplr.jl:310-364);
  * the infeasible branch: σ·=σfac, tolerance reset (src/sdplr.jl:365-370);
  * the rank-doubling counter, which exits to the caller;
  * L-BFGS clear + fg! re-sync at the boundary (src/sdplr.jl:389), which
    on the fast-diagonal engine also refreshes the carried CX exactly.

On a rank-local problem (``dp.spmd``; parallel/shardmap.py runs this
loop on every rank) the factor, its gradient, CX and the L-BFGS history
are this rank's rows and everything else is replicated: every reduction
is summed across ranks inside the operators, so every rank takes the
same branches (JAX package: solver/major.py under shard_map).

Scalars that the JAX carry holds as device values of the solve's dtype
(σ, tolerances, dual values) stay 0-dim tensors here, so float32 solves
round where the JAX package rounds; counters and flags are Python values.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.blocklanczos import block_lanczos_min_eig
from ..ops.device import DeviceProblem, fast_diag_eligible
from ..ops.entrymask import assemble_S_dense, entry_enabled, ls_dual_entry
from ..ops.lanczos import (
    lanczos_alpha_beta_impl,
    lanczos_alpha_beta_reorth_impl,
    lanczos_v0 as draw_lanczos_v0,
    tridiag_min_eig_device,
    tridiag_min_eig_device_certified,
)
from ..parallel.comm import dp_psum, local_rows, row_offset
from ..utils.timing import span
from .al import al_value_grad, al_value_grad_cx, capped_vio
from .inner import STATS as INNER_STATS
from .inner import SIGMA_CAP, InnerCarry, InnerGraphs, run_activation
from .inner_entry import entry_chunk
from .lbfgs import lbfgs_clear

BIG = 1e20


@dataclasses.dataclass
class MajorCarry:
    ic: InnerCarry            # R, G, y_full, vio_raw, L_val, grad_norm,
    #                           lbfgs, steps (this call), stagnated
    lam: torch.Tensor         # (m,)
    sigma: torch.Tensor       # 0-dim
    cur_ptol: torch.Tensor    # 0-dim
    cur_gtol: torch.Tensor    # 0-dim
    generator: torch.Generator  # Lanczos start vectors
    best_lam: torch.Tensor    # (m,) λ at the best dual value
    max_dual: torch.Tensor    # 0-dim
    min_gap: torch.Tensor     # 0-dim
    last_gap: torch.Tensor    # 0-dim: gap at the last feasible boundary
    rankupd_cnt: int          # countdown to rank doubling
    majoriters: int           # major boundaries crossed this call
    converged: bool
    rank_double: bool
    feas_count: int           # strict boundaries (dual bounds computed)
    dual_passes: int          # operator passes spent on dual bounds


def _vio_norm(dp: DeviceProblem, vio_raw, pscale):
    return torch.linalg.norm(capped_vio(dp, vio_raw)) / pscale


def major_chunk(
    dp: DeviceProblem,
    carry: MajorCarry,
    budget: int,          # inner-step budget of this call
    major_budget: int,    # major boundaries this call may cross
    base_iter: int,       # inner iterations before this call
    stag_tol,
    ptol_final,
    gtol_final,
    objtol,
    sigmafac,
    trace_bound,
    rankupd_tol: int,
    mega_data=None,       # ops/megakernel.MegaData(A) when mega_spec is set
    *,
    k: int,
    use_armijo: bool,
    gtol_relative: bool,
    ptol_relative: bool,
    objtol_relative: bool,
    q_max: int,
    highprecision: bool,
    dual_safeguard: bool = True,
    lbfgs_compact: bool = True,
    blk_b: int = 0,       # block-Lanczos dual bound (ops/blocklanczos.py):
    blk_kmax: int = 0,    # block size / max block steps; 0 = scalar path
    blk_margin_frac: float = 0.25,  # stop when tb·margin ≤ frac·objtol·|obj|
    blk_k_min: int = 4,   # minimum Krylov depth (block steps)
    mega_spec=None,       # ops/megakernel.MegaSpec: the inner loop runs
    mega_r: int = 0,      # as one megakernel call per activation
    lanczos_v0=None,      # (n_pad, 1) start vector for every bound of
    #                       this call; None draws from carry.generator
    entry_graphs=None,    # solver/inner_entry.EntryGraphs of the solve
    inner_graphs: InnerGraphs | None = None,  # solver/inner's, likewise
    #                       (None: one for this call)
):
    """Advance the solve by up to ``budget`` inner steps / ``major_budget``
    major boundaries. Returns (MajorCarry, vio_norm)."""
    dtype, dev = carry.ic.R.dtype, carry.ic.R.device
    m = dp.m
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    stag_tol, ptol_final, gtol_final = f(stag_tol), f(ptol_final), f(gtol_final)
    objtol, sigmafac, trace_bound = f(objtol), f(sigmafac), f(trace_bound)
    pscale = dp.normb if ptol_relative else 1.0
    logn = math.log(max(dp.n, 2))
    # fast-diagonal engine (solver/inner.py use_cx): only for the torch
    # inner loop; the megakernels and the entry engine carry
    # CX = None (fast_diag_eligible is false in entry mode)
    use_cx = mega_spec is None and fast_diag_eligible(dp)
    entry = entry_enabled(dp)
    if inner_graphs is None:
        inner_graphs = InnerGraphs()

    def state_flags(c: MajorCarry) -> list:
        """[healthy, inner active] in one host read. Healthy: stop on a
        numerically failed state (NaN L or σ overflow) instead of
        spinning the infeasible branch to the major limit."""
        healthy = (torch.isfinite(c.ic.L_val) & torch.isfinite(c.sigma)
                   & (c.sigma < SIGMA_CAP))
        active = (c.ic.grad_norm > c.cur_gtol) & (not c.ic.stagnated)
        INNER_STATS["branch_reads"] += 1
        return torch.stack([healthy, active]).tolist()

    def cond(c: MajorCarry) -> bool:
        return (not c.converged and not c.rank_double
                and c.ic.steps < budget and c.majoriters < major_budget)

    if mega_spec is not None:
        from ..ops.megakernel import mega_chunk

        def inner_branch(c: MajorCarry) -> MajorCarry:
            ic2, _ = mega_chunk(
                mega_spec, mega_r, m, pscale, mega_data, c.ic.R, c.ic.lbfgs,
                c.lam, c.sigma, c.cur_gtol, stag_tol, max(budget - c.ic.steps, 0),
            )
            ic2.steps = c.ic.steps + ic2.steps
            return dataclasses.replace(c, ic=ic2)
    elif entry:
        # the dense-mask inner loop: one call runs a whole activation;
        # the m-vector is converted only at this boundary
        def inner_branch(c: MajorCarry) -> MajorCarry:
            ic2, _ = entry_chunk(
                dp, c.ic.R, c.ic.G, c.ic.vio_raw, c.ic.L_val,
                c.ic.grad_norm, c.ic.lbfgs, c.lam, c.sigma, c.cur_gtol,
                stag_tol, max(budget - c.ic.steps, 0), k=k,
                gtol_relative=gtol_relative, ptol_relative=ptol_relative,
                lbfgs_compact=lbfgs_compact, graphs=entry_graphs)
            ic2.steps = c.ic.steps + ic2.steps
            return dataclasses.replace(c, ic=ic2)
    else:
        def inner_branch(c: MajorCarry) -> MajorCarry:
            ic2 = run_activation(
                dp, c.ic, c.lam, c.sigma, c.cur_gtol, stag_tol,
                max(budget - c.ic.steps, 0), k=k, use_armijo=use_armijo,
                gtol_relative=gtol_relative, lbfgs_compact=lbfgs_compact,
                use_cx=use_cx, graphs=inner_graphs)
            return dataclasses.replace(c, ic=ic2)

    def bound_for(c: MajorCarry, y_head):
        """Safeguarded Lanczos dual value for one multiplier estimate
        (reference: src/coreop.jl:376-415), on the block path when
        ``blk_b`` > 0. Returns (dual, passes): passes are operator
        applications (block steps on the block path)."""
        y_full = torch.cat([y_head, torch.ones(1, dtype=dtype, device=dev)])
        yb = torch.dot(y_full[:m], dp.b)
        # entry mode: S assembled densely once, each matvec one product
        S_dense = assemble_S_dense(dp, y_full) if entry else None
        if blk_b > 0:
            # block-Lanczos path: R-seeded start block, one b-lane operator
            # pass per step, early exit on the certified residual margin
            # (margin target mt in λ units). Always safeguarded
            denom = c.ic.vio_raw[m].abs() if objtol_relative \
                else torch.ones((), dtype=dtype, device=dev)
            mt = (blk_margin_frac * objtol * torch.clamp(denom, min=1e-8)
                  / torch.clamp(trace_bound, min=1.0))
            theta, margin, k_used = block_lanczos_min_eig(
                dp, y_full, c.generator, c.ic.R, float(mt), blk_k_min,
                b=blk_b, k_max=blk_kmax, S_dense=S_dense)
            min_eig = f(theta) - f(margin)
            return -yb + trace_bound * torch.clamp(min_eig, max=0.0), k_used
        v0 = (local_rows(dp, lanczos_v0) if lanczos_v0 is not None
              else draw_lanczos_v0(dp, c.generator, dtype))
        if highprecision:
            alpha, beta, k_eff = lanczos_alpha_beta_reorth_impl(
                dp, y_full, v0, q_max=q_max, S_dense=S_dense)
        else:
            # q = 2⌈max(iter,100)^0.5·log n⌉ (reference: src/coreop.jl:402)
            it = float(max(base_iter + c.ic.steps, 100))
            q = int(min(max(2.0 * math.ceil(math.sqrt(it) * logn), 1),
                        min(q_max, dp.n)))
            alpha, beta, k_eff = lanczos_alpha_beta_impl(
                dp, y_full, v0, q, q_max=q_max, S_dense=S_dense)
        if dual_safeguard:
            theta, margin = tridiag_min_eig_device_certified(
                alpha, beta, k_eff)
            min_eig = theta - margin
        else:
            min_eig = tridiag_min_eig_device(alpha, beta, k_eff)
        return -yb + trace_bound * min(min_eig, 0.0), int(k_eff)

    def dual_bound(c: MajorCarry):
        """Dual value at the least-squares multiplier on LS-eligible
        families and in entry mode (the masked-matrix CG multiplier),
        alternating with the AL ascent iterate across strict boundaries
        (one Lanczos per boundary), or at the AL iterate."""
        y_al = -torch.minimum(dp.lam_ub, c.lam - c.sigma * c.ic.vio_raw[:m])
        if not (entry or dp.ls_eligible):
            d_al, p_al = bound_for(c, y_al)
            return d_al, p_al, y_al
        from .dualbound import ls_dual_head

        if c.feas_count % 2 != 0:
            y = y_al
        elif entry:
            y = ls_dual_entry(dp, c.ic.R)
        else:
            CR = c.ic.CX if use_cx else None
            y = ls_dual_head(dp, c.ic.R, CR, y_fallback=y_al)
        d, p = bound_for(c, y)
        return d, p, y

    def certified_obj(c: MajorCarry):
        """Objective of the termination gap: on identity-diagonal problems
        ⟨C, X̂⟩ at the exactly feasible projection R̂ᵢ = Rᵢ·√bᵢ/‖Rᵢ‖, so
        the gap the solver stops on is the certificate it reports; in
        entry mode the entry certificate (``entry_certified_obj``)."""
        if dp.entry_trace_cert:
            return entry_certified_obj(dp, c.ic.vio_raw, objtol,
                                       objtol_relative)
        if not dp.diag_identity:
            return c.ic.vio_raw[m]
        from ..ops.spmm import spmm_C

        R = c.ic.R
        nrm2 = torch.sum(R * R, dim=1)
        rows = torch.arange(R.shape[0], device=dev) + row_offset(dp)
        zero = torch.zeros((), dtype=dtype, device=dev)
        b_row = torch.where(rows < dp.n,
                            dp.b[torch.clamp(rows, max=m - 1)], zero)
        alive = nrm2 > 0
        scale = torch.where(
            alive, torch.sqrt(b_row / torch.clamp(nrm2, min=1e-30)), zero)
        Rhat = R * scale[:, None]
        CRh = spmm_C(dp, Rhat)
        for t in dp.lowrank:  # diag_identity ⇒ every low-rank term is C's
            CRh = CRh + t.B @ (t.d[:, None] * dp_psum(t.B.T @ Rhat, dp))
        obj_cert = dp_psum(torch.sum(CRh * Rhat), dp)
        # dead rows make the projection infeasible — fall back to raw
        bad = bool(dp_psum(torch.any((rows < dp.n) & ~alive), dp) > 0)
        return c.ic.vio_raw[m] if bad else obj_cert

    def feasible_branch(c: MajorCarry, vio_norm) -> MajorCarry:
        """reference: src/sdplr.jl:310-364; the dual bound runs only at
        STRICT boundaries (vio ≤ final ptol)."""
        strict = bool(vio_norm <= ptol_final)
        best_lam, max_dual, feas_count = c.best_lam, c.max_dual, c.feas_count
        dual_passes = c.dual_passes
        if strict:
            with span("sdplr.dual_bound"):
                dual, passes, y_head = dual_bound(c)
                # `dual > max_dual` so a NaN dual never poisons the
                # running best
                better = bool(dual > c.max_dual)
            if better:
                best_lam, max_dual = -y_head, dual
            feas_count += 1
            obj = certified_obj(c)
            dual_passes += passes
        else:
            obj = c.ic.vio_raw[m]
        if objtol_relative:
            denom = torch.minimum(obj.abs(), max_dual.abs())
            gap = (obj - max_dual) / denom if bool(denom > 0) \
                else f(float("inf"))
        else:
            gap = obj - max_dual

        conv = strict and bool(gap <= objtol)
        # no-progress counter toward rank doubling (src/sdplr.jl:343-355)
        cnt = c.rankupd_cnt
        if strict and not conv:
            cnt = cnt - 1 if bool((c.min_gap - gap) < objtol) else rankupd_tol
        min_gap = gap if strict and bool(gap < c.min_gap) else c.min_gap
        rank_double = cnt == 0 and not conv

        # dual ascent + tighten (skipped on convergence / rank exit)
        lam, cur_ptol, cur_gtol = c.lam, c.cur_ptol, c.cur_gtol
        if not conv and not rank_double:
            lam = torch.minimum(dp.lam_ub, c.lam - c.sigma * c.ic.vio_raw[:m])
            cur_ptol = c.cur_ptol / c.sigma ** 0.9
            cur_gtol = c.cur_gtol / c.sigma
        return dataclasses.replace(
            c, lam=lam, cur_ptol=cur_ptol, cur_gtol=cur_gtol,
            best_lam=best_lam, max_dual=max_dual, min_gap=min_gap,
            last_gap=gap, rankupd_cnt=cnt, converged=conv,
            rank_double=rank_double, feas_count=feas_count,
            dual_passes=dual_passes,
        )

    def infeasible_branch(c: MajorCarry) -> MajorCarry:
        """reference: src/sdplr.jl:365-370."""
        sigma2 = c.sigma * sigmafac
        return dataclasses.replace(c, sigma=sigma2,
                                   cur_ptol=1.0 / sigma2 ** f(0.1),
                                   cur_gtol=1.0 / sigma2)

    def major_branch(c: MajorCarry) -> MajorCarry:
        vio_norm = _vio_norm(dp, c.ic.vio_raw, pscale)
        if bool(vio_norm <= c.cur_ptol):
            c = feasible_branch(c, vio_norm)
        else:
            c = infeasible_branch(c)
        # tolerance floors
        c = dataclasses.replace(
            c, cur_ptol=torch.maximum(c.cur_ptol, ptol_final),
            cur_gtol=torch.maximum(c.cur_gtol, gtol_final),
            majoriters=c.majoriters + 1,
        )
        if c.converged or c.rank_double:
            return c
        # L-BFGS clear + fg! re-sync (src/sdplr.jl:383,389); on the
        # fast-diagonal engine this also refreshes the carried CX from
        # scratch, bounding its drift to one major iteration
        L, vio_raw, G, y_full, gnorm, CX = _fg(
            dp, c.ic.R, c.lam, c.sigma, use_cx, gtol_relative, ptol_relative)
        ic2 = InnerCarry(R=c.ic.R, G=G, y_full=y_full, vio_raw=vio_raw,
                         L_val=L, grad_norm=gnorm,
                         lbfgs=lbfgs_clear(c.ic.lbfgs), steps=c.ic.steps,
                         stagnated=False, CX=CX)
        return dataclasses.replace(c, ic=ic2)

    while cond(carry):
        with span("sdplr.state_read"):
            healthy, inner_active = state_flags(carry)
        if not healthy:
            break
        if inner_active:
            with span("sdplr.inner"):
                carry = inner_branch(carry)
        else:
            with span("sdplr.boundary"):
                carry = major_branch(carry)
    return carry, _vio_norm(dp, carry.ic.vio_raw, pscale)


def entry_certified_obj(dp: DeviceProblem, vio_raw, objtol,
                        objtol_relative: bool):
    """The entry mode's termination objective (θ family,
    ``dp.entry_trace_cert``): the linear-feasible value
    ⟨C, X̂−E⟩ = s·obj − ⟨C, E⟩, where X̂ = s·RRᵀ meets the wide (trace)
    constraint exactly (s = b_w/(b_w+v_w) ≥ 0 keeps it PSD) and E zeroes
    the entry violations exactly; X̂−E meets every linear constraint and
    is only ε-PSD (λ_min ≥ −‖E‖). The rigorous PSD repair mixes with the
    feasible point X_I = c·I, charging t = δ/(δ + c); it is taken when its
    overhead fits in half the objtol budget, and capped there otherwise,
    so termination stays reachable while the ε-PSD undershoot is still
    charged. The reference terminates on the raw objective
    (src/sdplr.jl:334-357), which this never undercuts."""
    dtype, dev = vio_raw.dtype, vio_raw.device
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    gid_w = dp.extra_gids[0]
    b_w = dp.b[gid_w]
    denom_w = b_w + vio_raw[gid_w]
    s = torch.where(denom_w > 0, b_w / denom_w, f(0.0))
    ve = vio_raw[dp.entry_gids]
    cE = s * torch.sum(dp.entry_csgn * ve)            # ⟨C, E⟩ exactly
    c_mix = f(dp.entry_mix_c)
    mix_obj = c_mix * f(dp.n * dp.trC_n)              # ⟨C, X_I⟩
    lin = s * vio_raw[dp.m] - cE
    delta = s * torch.sqrt(2.0 * torch.sum(ve * ve))
    t_mix = delta / torch.clamp(delta + c_mix, min=torch.finfo(dtype).tiny)
    mixed = (1.0 - t_mix) * lin + t_mix * mix_obj
    budget = 0.5 * objtol * (torch.clamp(lin.abs(), min=1e-8)
                             if objtol_relative else f(1.0))
    val = torch.minimum(mixed, lin + budget)
    return torch.where(denom_w > 0, val, mix_obj)


def _fg(dp: DeviceProblem, R, lam, sigma, with_cx: bool,
        gtol_relative: bool, ptol_relative: bool):
    """fg!: (L, vio_raw, G, y_full, grad_norm, CX); CX = C@R on the
    fast-diagonal engine, else None."""
    if with_cx:
        L, vio_raw, G, y_full, gnorm, _, CX = al_value_grad_cx(
            dp, R, lam, sigma, gtol_relative, ptol_relative)
        return L, vio_raw, G, y_full, gnorm, CX
    L, vio_raw, G, y_full, gnorm, _ = al_value_grad(
        dp, R, lam, sigma, gtol_relative=gtol_relative,
        ptol_relative=ptol_relative)
    return L, vio_raw, G, y_full, gnorm, None


def init_major_carry(dp: DeviceProblem, R, lam, sigma, cur_ptol, cur_gtol,
                     generator: torch.Generator, lbfgs, rankupd_tol: int, *,
                     gtol_relative: bool, ptol_relative: bool,
                     with_cx: bool | None = None) -> MajorCarry:
    """Build the initial carry from host state (fresh or after rank
    doubling). Runs one fg! to populate (L, vio, G). ``with_cx`` must
    match the engine of the major_chunk this carry feeds (True iff the
    torch inner loop runs on a fast-diagonal problem); None decides as
    for a major_chunk without a megakernel."""
    dtype, dev = R.dtype, R.device
    if with_cx is None:
        with_cx = fast_diag_eligible(dp)
    L, vio_raw, G, y_full, gnorm, CX = _fg(
        dp, R, lam, sigma, with_cx, gtol_relative, ptol_relative)
    ic = InnerCarry(R=R, G=G, y_full=y_full, vio_raw=vio_raw, L_val=L,
                    grad_norm=gnorm, lbfgs=lbfgs, steps=0, stagnated=False,
                    CX=CX)
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    return MajorCarry(
        ic=ic, lam=lam, sigma=f(sigma), cur_ptol=f(cur_ptol),
        cur_gtol=f(cur_gtol), generator=generator, best_lam=lam,
        max_dual=f(-BIG), min_gap=f(BIG), last_gap=f(BIG),
        rankupd_cnt=int(rankupd_tol), majoriters=0, converged=False,
        rank_double=False, feas_count=0, dual_passes=0,
    )
