#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one H100, the CUDA
toolkit and PyTorch built for CUDA. It builds the port's CUDA kernels
from the sources in the checkout and runs these phases, one line each:

  1. device   the card, its compute capability (must be 9.0), its name
              and power limit as nvidia-smi reports them, the TF32 flags;
  2. build    nvcc of csrc/megakernel.cu (K1), csrc/megakernel_armijo.cu
              (K2), csrc/gather.cu (the gather kernels) and the four timing
              builds of phases 5 and 8 (K1 and megakernel_twoloop.cu, K1's
              design before the compact redesign, with -DK1_TIMING; K2 and
              megakernel_armijo_twoloop.cu with -DK2_TIMING), all seven
              started together, in seconds, and what ptxas reports of
              their registers and spills;
  3. K1       the inner-loop megakernel against its plain PyTorch version
              on the same inputs on the card: float64 at every step count
              0..25 to 1e-9 (R, G, the ring, and the ring's Grams SᵀY and
              YᵀY that K1 returns), float32 at 1 and 25 steps, the gtol
              exit, the ring round trip, and 5 steps from a ring the
              two-loop design left (3 of 4 slots filled, its Grams not
              kept), on a G1-shaped MaxCut (n_pad 896), MinBisection on
              the same graph (one low-rank term) and a G22-shaped MaxCut
              (n_pad 2048), all at rank 10;
  4. slice    the main path: sdplr(...) on the G1-shaped MaxCut in
              float32, with every launch count set to 0 just before and
              read just after; it must run on K1, reach pinfeas and gap
              ≤ 1e-2, and land within 1e-2 of the JAX package's objective;
  5. times    CUDA-event times in turns (plain, kernel, kernel, plain):
              K1 per iteration (the slope between 100 and 2000 steps with
              gtol -1 and the stagnation test off), its plain version's
              and the torch inner loop's per iteration, the bound, and the
              warm solve's seconds after one warm-up solve; then K1's time
              per iteration by phase from the timing builds (block 0's
              %globaltimer sums over a 2000-step launch, in turns two-loop,
              compact, compact, two-loop), before the redesign (the
              two-loop baseline) and after, with each design's grid
              barriers per iteration (2k + 3 = 11 before, at most 3 after);
  6. K2       the Armijo megakernel against its plain version at every
              step count 0..25 (float64 to 1e-9; float32 to K1's
              tolerances, on μ-conductance at steps 0 and 1 only, see the
              note in the phase), the gtol exit and the ring round trip,
              on μ-conductance on the G1-shaped graph (μ = 0.1, n_pad 896,
              three channels per row, one wide and one low-rank
              constraint), relaxed MaxCut with native inequalities on the
              same graph (one channel, dense C) and μ-conductance on the
              G22-shaped graph (n_pad 2048), all at rank 10; in float64
              the ring's Grams SᵀY and YᵀY that K2 returns too;
  7. mucond   the inequality path: sdplr(...) on μ-conductance on the
              G1-shaped graph in float32 (trace bound n·ub, the reference's
              experiment settings), with every launch count set to 0 just
              before and read just after; it must run on K2 with no K1
              launch, reach pinfeas and gap ≤ 1e-2, keep diag(X) inside its
              box and ⟨D, X⟩ = 1 to ptol, and land within 1e-2 of the JAX
              package's objective; its gather_rows launches and ELL SpMMs
              (the Lanczos passes), one launch per SpMM;
  8. times2   as 5 for K2 on the μ-conductance G1 state, with the torch
              Armijo inner loop (fast-diagonal engine) beside it; then
              K2's time per iteration by phase from the timing builds
              (block 0's %globaltimer sums over a 2000-step launch, in
              turns two-loop, compact, compact, two-loop), before the
              redesign (the two-loop baseline) and after, with each
              design's grid barriers per iteration (at most 3 after);
  9. gather   the three gather kernels of csrc/gather.cu against their
              plain versions, which must agree exactly (max |Δ| = 0):
              gather_rows at the SYN20K path's shapes (its tier-1 and
              tier-2 ELL column ids, X (20096, r) for r = 10 and 20, float32
              and float64, int64 and int32 ids) and at the probes' shapes (1
              and 8 rows per index) and at the SpMM's one index vector
              (tier-1 then tier-2 ids, DeviceProblem.ell_ids); gather_window at span/bucket (128, 512)
              and (1024, 512), and at r = 10 with int64 ids;
              gather_lanes on (8, 128) and (32, 1024) tiles
              and the (8·512, 1024) grid; then the probe entry points
              (sdplrplus_tpu_torch/probes.py) at the probes' shapes, with the
              launch counts set to 0 before and read after;
 10. syn20k   MaxCut at n = 20,000: sdplr(...) on SYN20K
              (synthetic_graph(20000, 16), 319,699 edges) in float32 with
              every launch count set to 0 just before and read just after;
              it must run the fast-diag-torch engine with no K1 or K2 launch
              and one gather_rows launch per ELL SpMM, take the
              block-Lanczos bound and no
              scalar one, reach pinfeas and gap ≤ 1e-2, land within 1e-2 of
              the JAX package's objective, and not over-certify: its gap
              must be at least the float64 gap at its own multiplier
              (λ_min by scipy's eigsh on the host) less 2e-3;
 11. times3   CUDA-event times in turns (plain, kernel, library, library,
              kernel, plain): gather_rows per SpMM (one launch over tier 1
              and tier 2) at the SYN20K shapes for r = 10 and 20 beside its
              bound, its plain version X[idx] and torch.index_select, each
              also per call from the host; the three kernels at the
              probes' shapes (N = 100,000, T = 2¹⁹, r = 16 and 32) with
              torch.index_select and torch.gather as library calls, each
              also timed per call from the host (launch cost included);
              the SYN20K inner loop and the warm μ-conductance solve with
              the SpMM's gather through the kernel and through X[idx], in
              turns; and the SYN20K solve's seconds, iterations, rank, dual
              bounds, block passes and gather launches.

Then a {"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, and the script
exits non-zero without that last line. It exits non-zero at once when no
CUDA device is present or when the package is not beside it.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# sdplrplus_tpu.sdplr (the JAX package) on the CPU, float32, on the same
# instance and arguments as phase 4:
#   A = make_random_graph(800, 0.83, seed=1); C, As, b = maxcut(A)
#   sdplr(C, As, b, 10, ptol=1e-2, objtol=1e-2, prior_trace_bound=800.0,
#         dtype="float32", seed=0)
# -> obj -11819.0537109375, pinfeas 9.64e-3, gap 2.80e-3, 158 iterations,
#    rank 10, engine dense-mxu.
JAX_G1_OBJ = -11819.0537109375

# sdplrplus_tpu.sdplr on the CPU, float32, on the instance of phase 7:
#   A = make_random_graph(800, 0.83, seed=1)
#   C, As, b, ct = mu_conductance_ineq(A, 0.1)
#   sdplr(C, As, b, 10, constraint_types=ct, ptol=1e-2, objtol=1e-2,
#         prior_trace_bound=800 * mu_conductance_ub(A.sum(), 0.1),
#         dtype="float32", seed=0)
# -> obj 0.7231850028038025, pinfeas 2.29e-4, gap 7.40e-3, 4272
#    iterations, 36 major iterations, rank 20, engine fast-diag-spmm.
JAX_MUCOND_G1_OBJ = 0.7231850028038025
MU = 0.1

# sdplrplus_tpu.sdplr on the CPU, float32, on the instance of phase 10:
#   A = synthetic_graph(20000, 16); C, As, b = maxcut(A)
#   sdplr(C, As, b, 10, ptol=1e-2, objtol=1e-2, prior_trace_bound=20000.0,
#         dtype="float32", seed=0)
# -> obj -213944.546875, pinfeas 5.40e-3, claimed gap 1.21e-3, 334
#    iterations, rank 10, engine fast-diag-spmm, one block bound of one
#    step. Its certificate over-certifies: float64 eigsh at its multiplier
#    gives a gap of 1.07e-2 (its block bound stops on the first step's
#    partial breakdown; the port deflates, ops/blocklanczos.py). The JAX
#    package's committed SYN20K artifact (exps/output/MaxCut/SYN20K/, a
#    TPU run: 3919 iterations, rank 20, 5 bounds of 105 block passes) has
#    obj -214563.25, 2.9e-3 from this one; phase 10 checks both.
JAX_SYN20K_OBJ = -213944.546875
JAX_SYN20K_ARTIFACT_OBJ = -214563.25

PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,       # non-tensor FP32
              "float64": 34e12}       # non-tensor FP64
RANK = 10
K = 4                                  # SolverConfig.numlbfgsvecs


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on an H100")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import sdplrplus_tpu_torch  # noqa: F401  (fails outside a checkout)
    from sdplrplus_tpu_torch import sdplr
    from sdplrplus_tpu_torch.compile import compile_problem
    from sdplrplus_tpu_torch.models import (
        make_random_graph, maxcut, minimum_bisection, mu_conductance_ineq,
        mu_conductance_lb, mu_conductance_ub, relaxed_maxcut_ineq,
    )
    from sdplrplus_tpu_torch import probes
    from sdplrplus_tpu_torch.models import synthetic_graph
    from sdplrplus_tpu_torch.ops import gather as ga
    from sdplrplus_tpu_torch.ops import megakernel as mk
    from sdplrplus_tpu_torch.ops import spmm as spmm_mod
    from sdplrplus_tpu_torch.solver import major as major_mod
    from sdplrplus_tpu_torch.ops.device import to_device
    from sdplrplus_tpu_torch.problem import SDPProblem
    from sdplrplus_tpu_torch.solver.al import al_value_grad
    from sdplrplus_tpu_torch.solver.inner import inner_chunk
    from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init
    from sdplrplus_tpu_torch.solver.outer import ENGINE_FAST, ENGINE_KERNEL

    dev = torch.device("cuda")

    # ---- 1. device -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    tf32_mm = torch.backends.cuda.matmul.allow_tf32
    say("device", f"{name} capability {cap[0]}.{cap[1]} | nvidia-smi: {smi}"
        f" | matmul.allow_tf32={tf32_mm} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    assert cap == (9, 0), f"K1 is built for sm_90a, got capability {cap}"
    assert tf32_mm is False, "TF32 matmul must stay off"

    # ---- 2. build: one nvcc per source, started together -----------------
    def build(kern):
        t0 = time.time()
        built = kern.built
        return kern, built, time.time() - t0

    libs = (mk.K1, mk.K2, ga.ROWS, mk.K1_TIMED, mk.K1_TWOLOOP_TIMED,
            mk.K2_TIMED, mk.K2_TWOLOOP_TIMED)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        builds = list(pool.map(build, libs))
    for kern, built, build_s in builds:
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        label = "gather kernels" if kern is ga.ROWS else kern.name
        say("build", f"{label}: {os.path.relpath(built.path)} in "
            f"{build_s:.1f} s (cached={built.cached}); ptxas: "
            f"{' / '.join(ptxas)}")

    def phase_breakdown(phase_runs):
        """{design: µs per iteration (sum of phases), grid barriers per
        iteration, entry barriers, µs per phase} from phase_times' turns,
        the median of each design's turns."""
        out = {}
        for who, runs in phase_runs.items():
            per = {ph: statistics.median(r[0][ph] for r in runs)
                   for ph in runs[0][0]}
            bars = {r[1] for r in runs}
            assert len(bars) == 1, (who, bars)
            out[who] = dict(us_per_iteration=round(sum(per.values()), 3),
                            barriers_per_iteration=bars.pop(),
                            entry_barriers=runs[0][2],
                            phases_us={k_: round(v, 3)
                                       for k_, v in per.items()})
        return out

    def zero_counts():
        for kern in (mk.K1, mk.K2) + ga.KERNELS:
            kern.launches = 0

    # ELL SpMMs, counted where spmm_C calls spmm_ell (phases 7 and 10)
    spmms = [0]
    real_spmm_ell = spmm_mod.spmm_ell

    def counted_spmm_ell(*a, **k):
        spmms[0] += 1
        return real_spmm_ell(*a, **k)

    # ---- problems --------------------------------------------------------
    g800 = make_random_graph(800, 0.83, seed=1)
    g2000 = make_random_graph(2000, 0.93, seed=1)
    cases = [("G1-shaped MaxCut", maxcut, g800),
             ("MinBisection, G1 graph", minimum_bisection, g800),
             ("G22-shaped MaxCut", maxcut, g2000)]
    compiled = {}
    for label, gen, A in cases:
        C, As, b = gen(A)
        compiled[label] = compile_problem(
            SDPProblem(C, As, np.asarray(b, np.float64), None))

    def kernel_state(label, dtype, seed=0):
        """A problem on the card and an inner-loop start state at the main
        path's shapes: R uniform(-1, 1), small multipliers, σ = 2. For
        MinBisection R's columns are centred, as on its solve path where
        1ᵀX1 = 0 holds to ptol: from an uncentred R the coupling term
        1ᵀX1 ≈ 2.7e3 puts a 1e5-sized constant into each gradient column,
        and float32 rounding of it alone moves R by 1e-3 in one step."""
        dp = to_device(compiled[label], dtype, dev)
        assert dp.C_dense is not None
        assert mk.megakernel_eligible(dp, RANK, K, False, dtype), label
        meta, data = mk.prepare_mega_data(dp, k=K, gtol_relative=True,
                                          ptol_relative=True)
        spec = mk.mega_spec_for(meta, RANK)
        rng = np.random.default_rng(seed)
        R = np.zeros((dp.n_pad, RANK))
        R[: dp.n] = rng.uniform(-1.0, 1.0, (dp.n, RANK))
        if label.startswith("MinBisection"):
            R[: dp.n] -= R[: dp.n].mean(axis=0)
        lam = 0.1 * rng.standard_normal(dp.m)
        t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
        return dp, meta, data, spec, t(R), t(lam), t(2.0)

    def run_k1(which, spec, meta, data, R, lbfgs, lam, sigma, gtol, stag,
               steps):
        """One activation through the kernel or its plain version, from
        the same inputs; returns (InnerCarry, vio_norm)."""
        args = mk.mega_inputs(spec, RANK, data, R, lbfgs, lam, sigma, gtol,
                              stag, steps)
        fn = mk.mega_kernel if which == "kernel" else mk.mega_chunk_plain
        out = fn(spec, *args)
        torch.cuda.synchronize()
        return mk.mega_carry(spec, RANK, meta["m"], meta["pscale"], data,
                             lam, sigma, args[6], args[7], out)

    def as_np(x):
        return x.detach().double().cpu().numpy()

    # ---- 3. K1 against its plain version ----------------------------------
    # Fixed-step comparisons run with the stagnation test off (-inf): a
    # tolerance of 0 still stops a float32 run once the line search's
    # predicted decrease rounds to <= 0 near convergence, and that step
    # differs between two correct float32 summation orders. float64 is
    # held at every step count 0..25 (each from the same start state);
    # float32 at 1 and 25 steps, where the compact form and its plain
    # version may round apart but stay within K1's tolerances.
    ninf = float("-inf")
    worst = {}

    def check_k1(label, dname, st, ck, vk, cp, vp):
        assert ck.steps == cp.steps == st, (ck.steps, cp.steps, st)
        tol = (1e-4 if st <= 1 else 3e-3) if dname == "float32" else 1e-9
        Lk, Lp = float(ck.L_val), float(cp.L_val)
        assert np.isfinite(Lk) and abs(Lk - Lp) / (abs(Lp) + 1) < tol, \
            (label, dname, st, Lk, Lp)
        np.testing.assert_allclose(as_np(ck.R), as_np(cp.R), rtol=tol,
                                   atol=tol * 10)
        np.testing.assert_allclose(as_np(ck.vio_raw), as_np(cp.vio_raw),
                                   rtol=tol, atol=tol * 10)
        assert abs(float(vk) - float(vp)) < tol * 10
        assert abs(float(ck.grad_norm) - float(cp.grad_norm)) \
            / (float(cp.grad_norm) + 1e-9) < 0.05
        if dname == "float64":
            for a, b_ in ((ck.G, cp.G), (ck.lbfgs.s_hist, cp.lbfgs.s_hist),
                          (ck.lbfgs.y_hist, cp.lbfgs.y_hist)):
                np.testing.assert_allclose(as_np(a), as_np(b_), rtol=tol,
                                           atol=tol)
            # the Grams K1 returns, to the ring's tolerance of their
            # largest entry
            for a, b_ in ((ck.lbfgs.sty, cp.lbfgs.sty),
                          (ck.lbfgs.yty, cp.lbfgs.yty)):
                ref = max(float(np.max(np.abs(as_np(b_)))), 1.0)
                assert np.max(np.abs(as_np(a) - as_np(b_))) <= tol * ref, \
                    (label, st, "gram")
            assert ck.lbfgs.head == cp.lbfgs.head
        return float(np.max(np.abs(as_np(ck.R) - as_np(cp.R))))

    for label, _, _ in cases:
        for dname, dtype in (("float32", torch.float32),
                             ("float64", torch.float64)):
            dp, meta, data, spec, R, lam, sigma = kernel_state(label, dtype)
            lb = lbfgs_init(K, dp.n_pad, RANK, dtype, dev)
            counts = range(26) if dname == "float64" else (1, 25)
            errs = []
            for steps in counts:
                ck, vk = run_k1("kernel", spec, meta, data, R, lb, lam,
                                sigma, 1e-12, ninf, steps)
                cp, vp = run_k1("plain", spec, meta, data, R, lb, lam,
                                sigma, 1e-12, ninf, steps)
                errs.append(check_k1(label, dname, steps, ck, vk, cp, vp))
            # ring round trip: 5 + 5 steps equal 10
            c5, _ = run_k1("kernel", spec, meta, data, R, lb, lam, sigma,
                           1e-12, ninf, 5)
            c55, _ = run_k1("kernel", spec, meta, data, c5.R, c5.lbfgs, lam,
                            sigma, 1e-12, ninf, 5)
            c10, _ = run_k1("kernel", spec, meta, data, R, lb, lam, sigma,
                            1e-12, ninf, 10)
            p10, _ = run_k1("plain", spec, meta, data, R, lb, lam, sigma,
                            1e-12, ninf, 10)
            rt_tol = 2e-3 if dname == "float32" else 1e-9
            assert c55.steps == 5 and c10.steps == 10
            for other in (c10, p10):
                np.testing.assert_allclose(as_np(c55.R), as_np(other.R),
                                           rtol=0, atol=rt_tol)
            # from a ring without Grams, the state the two-loop design
            # left: 3 steps fill 3 of the 4 slots, then SᵀY and YᵀY are
            # zeroed; K1 rebuilds them at entry and masks the empty slot
            c3, _ = run_k1("kernel", spec, meta, data, R, lb, lam, sigma,
                           1e-12, ninf, 3)
            assert c3.lbfgs.head == 3 and float(c3.lbfgs.sty.abs().max()) > 0
            c3.lbfgs.sty.zero_()
            c3.lbfgs.yty.zero_()
            ck, vk = run_k1("kernel", spec, meta, data, c3.R, c3.lbfgs, lam,
                            sigma, 1e-12, ninf, 5)
            cp, vp = run_k1("plain", spec, meta, data, c3.R, c3.lbfgs, lam,
                            sigma, 1e-12, ninf, 5)
            errs.append(check_k1(label + " (ring without Grams)", dname, 5,
                                 ck, vk, cp, vp))
            # gtol exit: a twentieth of the starting gradient norm
            _, _, _, _, gn0, _ = al_value_grad(dp, R, lam, sigma, True, True)
            gtol = 0.05 * float(gn0)
            ce, _ = run_k1("kernel", spec, meta, data, R, lb, lam, sigma,
                           gtol, 0.0, 10000)
            pe, _ = run_k1("plain", spec, meta, data, R, lb, lam, sigma,
                           gtol, 0.0, 10000)
            assert 0 < ce.steps < 10000 and float(ce.grad_norm) <= gtol
            assert 0 < pe.steps < 10000 and float(pe.grad_norm) <= gtol
            if dname == "float64":
                assert ce.steps == pe.steps, (ce.steps, pe.steps)
            worst[(label, dname)] = max(errs)
            say("K1", f"{label} n_pad {dp.n_pad} rp {spec.rp} {dname}: "
                f"steps {'0..25' if dname == 'float64' else '1 and 25'} "
                f"agree (max |ΔR| {max(errs):.3e}"
                f"{', Grams included' if dname == 'float64' else ''}), "
                f"5+5 = 10 steps, 5 steps from a ring without Grams, gtol exit "
                f"after {ce.steps} (plain {pe.steps}) steps")

    # ---- 4. the slice ------------------------------------------------------
    A = g800
    C, As, b = maxcut(A)
    kw = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=800.0,
              dtype="float32", seed=0, printlevel=0)
    zero_counts()
    t0 = time.time()
    res = sdplr(C, As, b, RANK, **kw)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = mk.K1.launches
    assert mk.K2.launches == 0, mk.K2.launches
    obj, pinf, gap = res["obj"], res["primal_vio"], res["rel_duality_gap"]
    rel = abs(obj - JAX_G1_OBJ) / abs(JAX_G1_OBJ)
    say("slice", f"G1-shaped MaxCut n={A.shape[0]} edges={A.nnz // 2}: "
        f"engine "
        f"{res['inner_engine']}, K1 launches {launches}, obj {obj!r}, "
        f"pinfeas {pinf:.3e}, gap {gap:.3e}, iterations {res['iter']}, "
        f"rank {res['r']}, |obj - JAX|/|JAX| {rel:.3e}, first solve "
        f"{cold_s:.3f} s")
    assert res["inner_engine"] == ENGINE_KERNEL, res["inner_engine"]
    assert launches > 0
    assert np.isfinite(obj) and np.all(np.isfinite(res["R"]))
    assert res["R"].shape == (800, res["r"])
    assert pinf <= 1e-2 and gap <= 1e-2, (pinf, gap)
    assert rel <= 1e-2, (obj, JAX_G1_OBJ)

    # ---- 5. times ----------------------------------------------------------
    dp, meta, data, spec, R, lam, sigma = kernel_state(
        "G1-shaped MaxCut", torch.float32)
    lb = lbfgs_init(K, dp.n_pad, RANK, torch.float32, dev)
    base = mk.mega_inputs(spec, RANK, data, R, lb, lam, sigma, -1.0, ninf,
                          1)

    def time_kernel(steps, reps=3):
        """ms of one K1 launch of ``steps`` iterations (median of reps)."""
        scal = base[0].clone()
        scal[3] = steps
        out = []
        for _ in range(reps + 1):
            s_ring, y_ring = base[6].clone(), base[7].clone()
            args = (scal,) + base[1:6] + (s_ring, y_ring) + base[8:]
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            o = mk.mega_kernel(spec, *args)
            e1.record()
            torch.cuda.synchronize()
            assert int(o[3][3]) == steps, (int(o[3][3]), steps)
            out.append(e0.elapsed_time(e1))
        return statistics.median(out[1:])

    def time_plain(steps, reps=2):
        scal = base[0].clone()
        scal[3] = steps
        out = []
        for _ in range(reps + 1):
            s_ring, y_ring = base[6].clone(), base[7].clone()
            args = (scal,) + base[1:6] + (s_ring, y_ring) + base[8:]
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            mk.mega_chunk_plain(spec, *args)
            e1.record()
            torch.cuda.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out[1:])

    L0, vio0, G0, y0, gn0, _ = al_value_grad(dp, R, lam, sigma, True, True)

    def time_torch_loop(steps, reps=2):
        out = []
        for _ in range(reps + 1):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            c, _ = inner_chunk(dp, R, G0, y0, vio0, L0, gn0,
                               lbfgs_init(K, dp.n_pad, RANK, torch.float32,
                                          dev),
                               lam, sigma, -1.0, ninf, steps, k=K,
                               use_armijo=False, gtol_relative=True,
                               ptol_relative=True)
            e1.record()
            torch.cuda.synchronize()
            assert c.steps == steps
            out.append(e0.elapsed_time(e1))
        return statistics.median(out[1:])

    turns = {"plain": [], "kernel": [], "torch": []}
    for who in ("plain", "kernel", "kernel", "plain"):
        if who == "kernel":
            t100, t2000 = time_kernel(100), time_kernel(2000)
            turns["kernel"].append((t100, (t2000 - t100) / 1900 * 1e3))
        else:
            t20, t100 = time_plain(20), time_plain(100)
            turns["plain"].append((t100, (t100 - t20) / 80 * 1e3))
            t20, t100 = time_torch_loop(20), time_torch_loop(100)
            turns["torch"].append((t100, (t100 - t20) / 80 * 1e3))
    med = {w: (statistics.median(a for a, _ in v),
               statistics.median(b for _, b in v)) for w, v in turns.items()}

    n, rp, lrc = spec.n_pad, spec.rp, sum(spec.lr_sizes)
    iters = 100
    ops = 2.0 * rp * n * n + iters * (2.0 * rp * n * n + (8 * K + 29) * rp * n
                                      + 18 * n + 6 * rp * n * lrc)
    nbytes = 4 * (n * n + 2 * rp * n + 3 * n + 2 * 2 * K * rp * n
                  + 3 * n * lrc + n + 2 * rp * n)
    bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                         ops / PEAK_FLOPS["float32"])
    bound_by = "operations" if ops / PEAK_FLOPS["float32"] \
        > nbytes / PEAK_BYTES_PER_S else "bytes"
    bound_us_iter = 1e6 * (2.0 * rp * n * n + (8 * K + 29) * rp * n
                           + 18 * n) / PEAK_FLOPS["float32"]

    t0 = time.time()
    res2 = sdplr(C, As, b, RANK, **kw)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    assert res2["primal_vio"] <= 1e-2 and res2["rel_duality_gap"] <= 1e-2
    # K1 by phase: the timing builds of the two-loop design (before the
    # redesign) and of the compact one, on the same state, in turns; block
    # 0's %globaltimer sums over one 2000-step launch, per iteration
    designs1 = {"two-loop": mk.K1_TWOLOOP_TIMED, "compact": mk.K1_TIMED}
    k1_runs = {w: [] for w in designs1}
    for who in ("two-loop", "compact", "compact", "two-loop"):
        k1_runs[who].append(mk.phase_times(designs1[who], spec, base, 2000))
    k1_breakdown = phase_breakdown(k1_runs)
    assert k1_breakdown["compact"]["barriers_per_iteration"] <= 3, \
        k1_breakdown
    assert k1_breakdown["two-loop"]["barriers_per_iteration"] \
        == 2 * K + 3, k1_breakdown

    say("times", f"G1 shapes n_pad {n} rp {rp} k {K} float32: K1 "
        f"{med['kernel'][1]:.2f} us/iter (100-step launch "
        f"{med['kernel'][0]:.3f} ms), plain version {med['plain'][1]:.1f} "
        f"us/iter (100 steps {med['plain'][0]:.1f} ms), torch inner loop "
        f"{med['torch'][1]:.1f} us/iter (100 steps {med['torch'][0]:.1f} "
        f"ms), bound {bound_us_iter:.3f} us/iter ({bound_ms:.4f} ms per "
        f"100-step launch, {bound_by}); turns {json.dumps(turns)}; K1 "
        f"launches per solve {launches}; warm solve {warm_s:.3f} s "
        f"({res2['iter']} iterations), first solve {cold_s:.3f} s; "
        f"nvidia-smi: {smi}")
    say("k1phases", f"K1 per iteration by phase (timing builds, block 0's "
        f"%globaltimer, 2000 steps, median of two turns each), G1-shaped "
        f"MaxCut float32: {json.dumps(k1_breakdown)}; nvidia-smi: {smi}")

    # ---- 6. K2 against its plain version ----------------------------------
    # μ-conductance keeps C sparse (its wide volume constraint), so its
    # problem comes from compile_problem's own choice; relaxed MaxCut with
    # native inequalities compiles to dense C.
    def mucond(A):
        C, As, b, ct = mu_conductance_ineq(A, MU)
        return C, As, b, ct

    cases2 = [("G1-shaped mu-conductance", mucond, g800),
              ("relaxed MaxCut (inequalities), G1 graph",
               relaxed_maxcut_ineq, g800),
              ("G22-shaped mu-conductance", mucond, g2000)]
    compiled2 = {}
    for label, gen, A in cases2:
        C, As, b, ct = gen(A)
        compiled2[label] = (A, compile_problem(
            SDPProblem(C, As, np.asarray(b, np.float64), ct)))

    def kernel_state2(label, dtype, seed=0):
        """A problem on the card and an inner-loop start state at the
        inequality path's shapes, inside the feasible region's scale:
        for μ-conductance R's columns are d-centred (the low-rank
        constraint dᵀX d = 0 holds) and R is scaled so ⟨D, X⟩ = 1, which
        puts diag(X) near 1/vol(G), inside the box [lb, ub]; for relaxed
        MaxCut each row has norm 1/1.01. Multipliers are small and
        within their upper bounds, σ = 2. From an unscaled uniform R the
        box violations are 10⁴× the box and the AL 10⁹, and float32
        rounding alone moves a 25-step trajectory."""
        A, cp = compiled2[label]
        dp = to_device(cp, dtype, dev)
        assert mk.megakernel_eligible(dp, RANK, K, True, dtype), label
        meta, data = mk.prepare_mega_data(dp, k=K, gtol_relative=True,
                                          ptol_relative=True)
        spec = mk.mega_spec_for(meta, RANK)
        assert spec.armijo, label
        rng = np.random.default_rng(seed)
        Rn = rng.uniform(-1.0, 1.0, (dp.n, RANK))
        if "mu-conductance" in label:
            d = np.asarray(A.sum(axis=1)).reshape(-1)
            Rn -= np.outer(np.ones(dp.n), d @ Rn / d.sum())
            Rn /= np.sqrt(np.sum(d * np.sum(Rn * Rn, axis=1)))
        else:
            Rn /= 1.01 * np.linalg.norm(Rn, axis=1, keepdims=True)
        R = np.zeros((dp.n_pad, RANK))
        R[: dp.n] = Rn
        lam = np.minimum(0.1 * rng.standard_normal(dp.m),
                         dp.lam_ub.cpu().numpy())
        t = lambda x: torch.tensor(x, dtype=dtype, device=dev)
        return dp, meta, data, spec, t(R), t(lam), t(2.0)

    def run_k2(which, spec, meta, data, R, lbfgs, lam, sigma, gtol, stag,
               steps):
        args = mk.mega_inputs(spec, RANK, data, R, lbfgs, lam, sigma, gtol,
                              stag, steps)
        fn = mk.mega_kernel_armijo if which == "kernel" \
            else mk.mega_chunk_armijo_plain
        out = fn(spec, *args)
        torch.cuda.synchronize()
        c, v = mk.mega_carry(spec, RANK, meta["m"], meta["pscale"], data,
                             lam, sigma, *mk.rings_of(spec, args), out)
        return c, v, float(out[3][5])     # the last step's α

    # Each step count s = 0..25 runs from the same state through the kernel
    # and through its plain version. μ-conductance's AL is stiff (the
    # low-rank term ddᵀ, ‖d‖² ≈ 1.5e7 at G1), so rounding differences grow
    # from step to step: in float64 by ~10³ over 25 steps, in float32 until
    # the trajectories part within 8–9 steps, with or without an Armijo
    # tie (a probe on the card, and the port's plain version against the
    # JAX package's K2 on the CPU, show the same). So every case is held
    # in float64 at every step to 1e-9 with the same α at every step;
    # relaxed MaxCut, which is well conditioned, also in float32 over 25
    # steps at K1's tolerances (1e-4 at s ≤ 1, 3e-3 after); μ-conductance
    # in float32 at s ≤ 1 at 1e-4, with the step where the α first differ
    # and the gap in ℒ after 25 steps reported.
    worst2 = {}
    for label, _, _ in cases2:
        for dname, dtype in (("float32", torch.float32),
                             ("float64", torch.float64)):
            dp, meta, data, spec, R, lam, sigma = kernel_state2(label, dtype)
            lb = lbfgs_init(K, dp.n_pad, RANK, dtype, dev)
            runs = {w: [run_k2(w, spec, meta, data, R, lb, lam, sigma,
                               1e-12, ninf, st) for st in range(26)]
                    for w in ("kernel", "plain")}
            stiff = "mu-conductance" in label and dname == "float32"
            last = 1 if stiff else 25
            errs = []
            for st in range(last + 1):
                (ck, vk, ak), (cp, vp, ap) = runs["kernel"][st], \
                    runs["plain"][st]
                assert ck.steps == cp.steps == st, (ck.steps, cp.steps)
                assert ak == ap, (label, dname, st, ak, ap)
                tol = (1e-4 if st <= 1 else 3e-3) \
                    if dname == "float32" else 1e-9
                Lk, Lp = float(ck.L_val), float(cp.L_val)
                assert np.isfinite(Lk) and abs(Lk - Lp) / (abs(Lp) + 1) \
                    < tol, (label, dname, st, Lk, Lp)
                np.testing.assert_allclose(as_np(ck.R), as_np(cp.R),
                                           rtol=tol, atol=tol * 10)
                np.testing.assert_allclose(as_np(ck.vio_raw),
                                           as_np(cp.vio_raw), rtol=tol,
                                           atol=tol * 10)
                assert abs(float(vk) - float(vp)) < tol * 10
                assert abs(float(ck.grad_norm) - float(cp.grad_norm)) \
                    / (float(cp.grad_norm) + 1e-9) < 0.05
                if dname == "float64":
                    # G = 2·S(y)·R carries σ·v·ddᵀR on μ-conductance, which
                    # multiplies R's rounding-level differences: after 25
                    # float64 steps the port's plain version and the JAX
                    # package's K2 differ by 1.3e-6 of max|G| on this
                    # state while R agrees to 6e-9 (on the CPU). So G and
                    # the ring are held to their largest entry, at 1e-5
                    for a, b_ in ((ck.G, cp.G), (ck.lbfgs.s_hist,
                                                 cp.lbfgs.s_hist),
                                  (ck.lbfgs.y_hist, cp.lbfgs.y_hist)):
                        ref = np.max(np.abs(as_np(b_)))
                        assert np.max(np.abs(as_np(a) - as_np(b_))) \
                            <= 1e-5 * ref, (label, st)
                    # the Grams K2 returns, held as the ring is
                    for a, b_ in ((ck.lbfgs.sty, cp.lbfgs.sty),
                                  (ck.lbfgs.yty, cp.lbfgs.yty)):
                        ref = np.max(np.abs(as_np(b_)))
                        assert np.max(np.abs(as_np(a) - as_np(b_))) \
                            <= 1e-5 * ref, (label, st, "gram")
                    assert ck.lbfgs.head == cp.lbfgs.head
                if st:
                    errs.append(float(np.max(np.abs(as_np(ck.R)
                                                    - as_np(cp.R)))))
            first_diff = next((st for st in range(1, 26)
                               if runs["kernel"][st][2]
                               != runs["plain"][st][2]), None)
            L25 = [float(runs[w][25][0].L_val) for w in ("kernel", "plain")]
            gap25 = abs(L25[0] - L25[1]) / (abs(L25[1]) + 1)
            # ring round trip: h + h steps equal 2h
            h = 1 if stiff else 5
            ch, _, _ = run_k2("kernel", spec, meta, data, R, lb, lam, sigma,
                              1e-12, ninf, h)
            chh, _, _ = run_k2("kernel", spec, meta, data, ch.R, ch.lbfgs,
                               lam, sigma, 1e-12, ninf, h)
            assert chh.steps == h
            rt_tol = (1e-4 if stiff else 2e-3) if dname == "float32" \
                else 1e-9
            for w in ("kernel", "plain"):
                np.testing.assert_allclose(as_np(chh.R),
                                           as_np(runs[w][2 * h][0].R),
                                           rtol=0, atol=rt_tol)
            # gtol exit, from the plain version's state after one step (the
            # start itself sits at a low gradient norm on μ-conductance):
            # gtol at the first later record-low norm of the plain
            # trajectory, where it stops
            c1 = runs["plain"][1][0]
            gns = [float(runs["plain"][st][0].grad_norm) for st in range(26)]
            recs = [st for st in range(2, 26) if gns[st] < min(gns[1:st])]
            assert recs, (label, dname, gns)
            gtol = gns[recs[0]] * (1.0 + (1e-3 if dname == "float32"
                                          else 1e-9))
            s_g = min(st for st in range(2, 26) if gns[st] <= gtol) - 1
            ce, _, _ = run_k2("kernel", spec, meta, data, c1.R, c1.lbfgs,
                              lam, sigma, gtol, ninf, 10000)
            pe, _, _ = run_k2("plain", spec, meta, data, c1.R, c1.lbfgs, lam,
                              sigma, gtol, ninf, 10000)
            assert 0 < ce.steps < 10000 and float(ce.grad_norm) <= gtol
            assert 0 < pe.steps < 10000 and float(pe.grad_norm) <= gtol
            if dname == "float64":
                assert ce.steps == pe.steps == s_g, (ce.steps, pe.steps, s_g)
            worst2[(label, dname)] = max(errs)
            say("K2", f"{label} n_pad {dp.n_pad} rp {spec.rp} J {spec.J} "
                f"wide {spec.n_wide} {dname}: steps 0..{last} agree (max "
                f"|ΔR| {max(errs):.3e}); α first differs at step "
                f"{first_diff}, ℒ after 25 steps differs by {gap25:.2e} "
                f"(relative); {h}+{h} = {2 * h} steps, gtol exit after "
                f"{ce.steps} (plain {pe.steps}) steps")

    # ---- 7. the inequality slice ---------------------------------------------
    A = g800
    C2, As2, b2, ct2 = mucond(A)
    volG = float(A.sum())
    ub, lbox = mu_conductance_ub(volG, MU), mu_conductance_lb(volG, MU)
    kw2 = dict(constraint_types=ct2, ptol=1e-2, objtol=1e-2,
               prior_trace_bound=A.shape[0] * ub, dtype="float32", seed=0,
               printlevel=0)
    zero_counts()
    spmms[0] = 0
    spmm_mod.spmm_ell = counted_spmm_ell
    t0 = time.time()
    res = sdplr(C2, As2, b2, RANK, **kw2)
    torch.cuda.synchronize()
    cold2_s = time.time() - t0
    spmm_mod.spmm_ell = real_spmm_ell
    launches2, k1_during = mk.K2.launches, mk.K1.launches
    rows2, spmms2 = ga.ROWS.launches, spmms[0]
    obj, pinf, gap = res["obj"], res["primal_vio"], res["rel_duality_gap"]
    rel = abs(obj - JAX_MUCOND_G1_OBJ) / abs(JAX_MUCOND_G1_OBJ)
    X_diag = np.sum(res["R"] ** 2, axis=1)
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    normb = float(np.linalg.norm(b2))
    box = (float(np.max(X_diag - ub)), float(np.max(lbox - X_diag)))
    vol = float(d @ X_diag) - 1.0
    say("mucond", f"G1-shaped mu-conductance n={A.shape[0]} m={len(b2)}: "
        f"engine {res['inner_engine']}, K2 launches {launches2}, K1 "
        f"launches {k1_during}, obj {obj!r}, pinfeas {pinf:.3e}, gap "
        f"{gap:.3e}, iterations {res['iter']}, majors {res['majoriter']}, "
        f"rank {res['r']}, dual bounds {res['dual_bounds_computed']} "
        f"({res['dual_passes']} Lanczos passes), |obj - JAX|/|JAX| "
        f"{rel:.3e}, max(X_ii - ub) "
        f"{box[0]:.3e}, max(lb - X_ii) {box[1]:.3e}, <D,X> - 1 {vol:.3e}, "
        f"gather_rows launches {rows2} for {spmms2} ELL SpMMs, "
        f"first solve {cold2_s:.3f} s")
    assert res["inner_engine"] == ENGINE_KERNEL, res["inner_engine"]
    assert launches2 > 0 and k1_during == 0, (launches2, k1_during)
    assert rows2 == spmms2 > 0, (rows2, spmms2)
    assert np.isfinite(obj) and np.all(np.isfinite(res["R"]))
    assert res["R"].shape == (800, res["r"])
    assert pinf <= 1e-2 and gap <= 1e-2, (pinf, gap)
    assert max(box) <= 1e-2 * normb and abs(vol) <= 2e-2 * normb, (box, vol)
    assert rel <= 1e-2, (obj, JAX_MUCOND_G1_OBJ)

    # ---- 8. K2 times ---------------------------------------------------------
    label = "G1-shaped mu-conductance"
    dp, meta, data, spec, R, lam, sigma = kernel_state2(label, torch.float32)
    lb = lbfgs_init(K, dp.n_pad, RANK, torch.float32, dev)
    base2 = mk.mega_inputs(spec, RANK, data, R, lb, lam, sigma, -1.0, ninf,
                           1)

    def time_k2(fn, steps, reps):
        """ms of one launch of ``steps`` iterations (median of reps)."""
        scal = base2[0].clone()
        scal[3] = steps
        out = []
        for _ in range(reps + 1):
            s_ring, y_ring = base2[8].clone(), base2[9].clone()
            args = (scal,) + base2[1:8] + (s_ring, y_ring) + base2[10:]
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            o = fn(spec, *args)
            e1.record()
            torch.cuda.synchronize()
            assert int(o[3][3]) == steps, (int(o[3][3]), steps)
            out.append(e0.elapsed_time(e1))
        return statistics.median(out[1:])

    L0, vio0, G0, y0, gn0, _ = al_value_grad(dp, R, lam, sigma, True, True)

    def time_torch_armijo(steps, reps=2):
        out = []
        for _ in range(reps + 1):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            c, _ = inner_chunk(dp, R, G0, y0, vio0, L0, gn0,
                               lbfgs_init(K, dp.n_pad, RANK, torch.float32,
                                          dev),
                               lam, sigma, -1.0, ninf, steps, k=K,
                               use_armijo=True, gtol_relative=True,
                               ptol_relative=True)
            e1.record()
            torch.cuda.synchronize()
            assert c.steps == steps
            out.append(e0.elapsed_time(e1))
        return statistics.median(out[1:])

    turns2 = {"plain": [], "kernel": [], "torch": []}
    for who in ("plain", "kernel", "kernel", "plain"):
        if who == "kernel":
            t100 = time_k2(mk.mega_kernel_armijo, 100, 3)
            t2000 = time_k2(mk.mega_kernel_armijo, 2000, 3)
            turns2["kernel"].append((t100, (t2000 - t100) / 1900 * 1e3))
        else:
            t20 = time_k2(mk.mega_chunk_armijo_plain, 20, 2)
            t100 = time_k2(mk.mega_chunk_armijo_plain, 100, 2)
            turns2["plain"].append((t100, (t100 - t20) / 80 * 1e3))
            t20, t100 = time_torch_armijo(20), time_torch_armijo(100)
            turns2["torch"].append((t100, (t100 - t20) / 80 * 1e3))
    med2 = {w: (statistics.median(a for a, _ in v),
                statistics.median(b for _, b in v))
            for w, v in turns2.items()}

    n, rp, J, n_w = spec.n_pad, spec.rp, spec.J, spec.n_wide
    lrc = sum(spec.lr_sizes)
    # per iteration: D·C, the vector work of K1's iteration, the channel
    # state, and one Armijo candidate (the least the search needs)
    it_ops = (2.0 * rp * n * n + (8 * K + 29) * rp * n + 6 * rp * n * lrc
              + (20 + 8) * J * n + 4 * n_w * n)
    ops2 = 2.0 * rp * n * n + iters * it_ops
    nbytes2 = 4 * (n * n + 2 * rp * n + 5 * J * n + n_w * n
                   + 2 * 2 * K * rp * n + 3 * n * lrc + 2 * rp * n)
    bound2_ms = 1e3 * max(nbytes2 / PEAK_BYTES_PER_S,
                          ops2 / PEAK_FLOPS["float32"])
    bound2_by = "operations" if ops2 / PEAK_FLOPS["float32"] \
        > nbytes2 / PEAK_BYTES_PER_S else "bytes"
    bound2_us_iter = 1e6 * it_ops / PEAK_FLOPS["float32"]

    t0 = time.time()
    res2 = sdplr(C2, As2, b2, RANK, **kw2)
    torch.cuda.synchronize()
    warm2_s = time.time() - t0
    assert res2["primal_vio"] <= 1e-2 and res2["rel_duality_gap"] <= 1e-2
    say("times2", f"mu-conductance G1 shapes n_pad {n} rp {rp} J {J} wide "
        f"{n_w} k {K} float32: K2 {med2['kernel'][1]:.2f} us/iter (100-step "
        f"launch {med2['kernel'][0]:.3f} ms), plain version "
        f"{med2['plain'][1]:.1f} us/iter (100 steps {med2['plain'][0]:.1f} "
        f"ms), torch Armijo inner loop {med2['torch'][1]:.1f} us/iter (100 "
        f"steps {med2['torch'][0]:.1f} ms), bound {bound2_us_iter:.3f} "
        f"us/iter ({bound2_ms:.4f} ms per 100-step launch, {bound2_by}); "
        f"turns {json.dumps(turns2)}; K2 launches per solve {launches2}; "
        f"warm solve {warm2_s:.3f} s ({res2['iter']} iterations), first "
        f"solve {cold2_s:.3f} s; nvidia-smi: {smi}")

    # K2 by phase: the timing builds of the two-loop design (before the
    # redesign) and of the compact one, on the same state, in turns; block
    # 0's %globaltimer sums over one 2000-step launch, per iteration
    designs = {"two-loop": mk.K2_TWOLOOP_TIMED, "compact": mk.K2_TIMED}
    phase_runs = {w: [] for w in designs}
    for who in ("two-loop", "compact", "compact", "two-loop"):
        phase_runs[who].append(mk.phase_times(designs[who], spec, base2,
                                              2000))
    breakdown = phase_breakdown(phase_runs)
    assert breakdown["compact"]["barriers_per_iteration"] <= 3, breakdown
    say("k2phases", f"K2 per iteration by phase (timing builds, block 0's "
        f"%globaltimer, 2000 steps, median of two turns each), "
        f"mu-conductance G1 shapes float32: {json.dumps(breakdown)}; "
        f"nvidia-smi: {smi}")

    # ---- 9. the gather kernels against their plain versions -------------
    n_syn = 20000
    A_syn = synthetic_graph(n_syn, 16)
    C_syn, As_syn, b_syn = maxcut(A_syn)
    t0 = time.time()
    cp_syn = compile_problem(SDPProblem(C_syn, As_syn,
                                        np.asarray(b_syn, np.float64), None))
    compile_s = time.time() - t0
    dp_syn = to_device(cp_syn, torch.float32, dev)
    assert dp_syn.C_dense is None and dp_syn.has_ell2
    ell1 = dp_syn.ell_cols.reshape(-1).contiguous()
    ell2 = dp_syn.ell2_cols.reshape(-1).contiguous()
    gen = torch.Generator().manual_seed(0)

    gather_err = {k.name: 0.0 for k in ga.KERNELS}

    def exact(got, want, what, kernel="gather_rows"):
        assert got.shape == want.shape and got.dtype == want.dtype, what
        err = float((got - want).abs().max()) if got.numel() else 0.0
        assert torch.equal(got, want) and err == 0.0, (what, err)
        gather_err[kernel] = max(gather_err[kernel], err)

    checked = []
    for r in (10, 20):
        for dt in (torch.float32, torch.float64):
            X = torch.randn((dp_syn.n_pad, r), generator=gen,
                            dtype=dt).to(dev)
            X[n_syn:] = 0.0          # the guaranteed-zero padding rows
            for name, ids in (("tier 1", ell1), ("tier 2", ell2),
                              ("tiers 1+2", dp_syn.ell_ids)):
                for idt in (torch.int64, torch.int32):
                    i = ids.to(idt)
                    exact(ga.gather_rows(X, i), ga.gather_rows_plain(X, i),
                          (name, r, dt, idt))
            checked.append(f"r={r} {str(dt)[6:]}")
    torch.cuda.synchronize()
    X16 = torch.randn((probes.N, 16), generator=gen).to(dev)
    X32 = torch.randn((probes.N, 32), generator=gen).to(dev)
    idx = torch.randint(0, probes.N, (probes.T,), generator=gen,
                        dtype=torch.int32).to(dev)
    for X in (X16, X32):
        exact(ga.gather_rows(X, idx), ga.gather_rows_plain(X, idx), "P1/P3")
    idx8 = torch.randint(0, probes.N // 8, (probes.T // 8,), generator=gen,
                         dtype=torch.int32).to(dev)
    exact(ga.gather_rows(X16, idx8, 8), ga.gather_rows_plain(X16, idx8, 8),
          "P4 q=8")
    Xt = torch.randn((1024, 16), generator=gen).to(dev)
    it = torch.randint(0, 1024, (512,), generator=gen,
                       dtype=torch.int32).to(dev)
    exact(ga.gather_rows(Xt, it), ga.gather_rows_plain(Xt, it), "P2 tile")
    for span, bucket in ((128, 512), (1024, 512)):
        for X in (X16, X32):
            wins = torch.randint(0, probes.N // span, (probes.T // bucket,),
                                 generator=gen, dtype=torch.int32).to(dev)
            offs = torch.randint(0, span, (probes.T,), generator=gen,
                                 dtype=torch.int32).to(dev)
            exact(ga.gather_window(X, wins, offs, span, bucket),
                  ga.gather_window_plain(X, wins, offs, span, bucket),
                  ("P5/P6", span, bucket), "gather_window")
    # the row template's 8-byte vectors (r = 10) and int64 ids
    X10 = torch.randn((probes.N, 10), generator=gen).to(dev)
    w64 = torch.randint(0, probes.N // 128, (probes.T // 512,),
                        generator=gen).to(dev)
    o64 = torch.randint(0, 128, (probes.T,), generator=gen).to(dev)
    exact(ga.gather_window(X10, w64, o64, 128, 512),
          ga.gather_window_plain(X10, w64, o64, 128, 512),
          ("window r=10 int64",), "gather_window")
    for S, L in ((8, 128), (32, 1024), (8 * 512, 1024)):
        for dt in (torch.float32, torch.float64):
            Xl = torch.randn((S, L), generator=gen, dtype=dt).to(dev)
            il = torch.randint(0, L, (S, L), generator=gen,
                               dtype=torch.int32).to(dev)
            exact(ga.gather_lanes(Xl, il), ga.gather_lanes_plain(Xl, il),
                  ("P7/P8", S, L, dt), "gather_lanes")
    torch.cuda.synchronize()
    # the probe entry points, each probe once at its own shapes
    zero_counts()
    wins = torch.randint(0, probes.N // 128, (probes.T // 512,),
                         generator=gen, dtype=torch.int32).to(dev)
    offs = torch.randint(0, 128, (probes.T // 512, 512), generator=gen,
                         dtype=torch.int32).to(dev)
    idx_dma = (idx % (probes.N // 8)).contiguous()   # 8 rows per index
    Xg = torch.randn((8 * 512, 1024), generator=gen).to(dev)
    ig = torch.randint(0, 1024, (8 * 512, 1024), generator=gen,
                       dtype=torch.int32).to(dev)
    probe_out = {
        "P1": probes.full_take_call(X16, idx, 16),
        "P2": probes.sublane_take_call(Xt, it, 1024, 512, 16),
        "P3": probes.pallas_take_call(X32, idx, 32),
        "P4": probes.dma_gather(X16, idx_dma, 16, 8, 8),
        "P5": probes.onehot_call(X16, wins, offs, 16, 128, 512),
        "P6": probes.pallas_onehot_call(X16, wins, offs.reshape(-1), 16),
        "P7": probes.lane_gather_call(Xg[:32], ig[:32], 32, 1024),
        "P8": probes.lane_gather_grid(Xg, ig, 8, 1024, 512),
    }
    torch.cuda.synchronize()
    probe_launches = {k.name: k.launches for k in ga.KERNELS}
    assert probe_launches == {"gather_rows": 4, "gather_window": 2,
                              "gather_lanes": 2}, probe_launches
    exact(probe_out["P5"], probe_out["P6"], "P5 = P6 at span 128",
          "gather_window")
    exact(probe_out["P4"],
          ga.gather_rows_plain(X16, idx_dma[:probes.T // 8], 8),
          "P4 entry")
    say("gather", f"gather_rows = X[idx] exactly (max |Δ| 0) at SYN20K's "
        f"tier-1 ({ell1.numel()} ids) and tier-2 ({ell2.numel()} ids) "
        f"columns and at the SpMM's one vector of both "
        f"({dp_syn.ell_ids.numel()} ids) for {', '.join(checked)}, int64 "
        f"and int32 ids, and at "
        f"the probes' shapes (X ({probes.N}, 16/32), T = {probes.T}, 1 and "
        f"8 rows per index); gather_window exact at span/bucket (128, 512) "
        f"and (1024, 512) at r = 16 and 32, and at r = 10 with int64 ids; "
        f"gather_lanes exact on (8, 128), (32, 1024) and "
        f"(4096, 1024) in float32 and float64; probe entry points P1-P8 "
        f"launched {probe_launches}; SYN20K compile_problem {compile_s:.2f} "
        f"s")

    # ---- 10. SYN20K on the block-Lanczos bound --------------------------
    # count the dual bounds by path (the solver's own calls, unchanged)
    bounds = {"block": 0, "scalar": 0, "b": set(), "passes": 0}
    real_block = major_mod.block_lanczos_min_eig
    real_scalar = (major_mod.lanczos_alpha_beta_impl,
                   major_mod.lanczos_alpha_beta_reorth_impl)

    def counted_block(*a, **k):
        out = real_block(*a, **k)
        bounds["block"] += 1
        bounds["b"].add(k["b"])
        bounds["passes"] += out[2]
        return out

    def counted_scalar(fn):
        def run(*a, **k):
            bounds["scalar"] += 1
            return fn(*a, **k)
        return run

    major_mod.block_lanczos_min_eig = counted_block
    major_mod.lanczos_alpha_beta_impl = counted_scalar(real_scalar[0])
    major_mod.lanczos_alpha_beta_reorth_impl = counted_scalar(real_scalar[1])
    kw3 = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=float(n_syn),
               dtype="float32", seed=0, printlevel=0)
    zero_counts()
    spmms[0] = 0
    spmm_mod.spmm_ell = counted_spmm_ell
    t0 = time.time()
    res3 = sdplr(C_syn, As_syn, b_syn, RANK, **kw3)
    torch.cuda.synchronize()
    syn_s = time.time() - t0
    spmm_mod.spmm_ell = real_spmm_ell
    syn_launches = {k.name: k.launches for k in (mk.K1, mk.K2) + ga.KERNELS}
    syn_spmms = spmms[0]
    major_mod.block_lanczos_min_eig = real_block
    major_mod.lanczos_alpha_beta_impl, \
        major_mod.lanczos_alpha_beta_reorth_impl = real_scalar
    obj3, pinf3, gap3 = (res3["obj"], res3["primal_vio"],
                         res3["rel_duality_gap"])
    rel3 = abs(obj3 - JAX_SYN20K_OBJ) / abs(JAX_SYN20K_OBJ)
    rel3a = abs(obj3 - JAX_SYN20K_ARTIFACT_OBJ) / abs(JAX_SYN20K_ARTIFACT_OBJ)
    # float64 certificate at the solver's own multiplier, on the host
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh

    t0 = time.time()
    y_h = -np.asarray(res3["lambda"], np.float64)
    S64 = sp.csr_matrix((C_syn.vals, (C_syn.rows, C_syn.cols)),
                        shape=(n_syn, n_syn)) + sp.diags(y_h)
    lam_min64 = float(eigsh(S64, k=1, which="SA", tol=1e-7)[0][0])
    eigsh_s = time.time() - t0
    dual64 = float(-y_h @ np.asarray(b_syn, np.float64)) \
        + n_syn * min(lam_min64, 0.0)
    obj_f = res3["obj_feasible"] if res3["obj_feasible"] is not None \
        else obj3
    gap64 = (obj_f - dual64) / min(abs(obj_f), abs(dual64))
    say("syn20k", f"SYN20K MaxCut n={n_syn} edges={A_syn.nnz // 2}: engine "
        f"{res3['inner_engine']}, launches {syn_launches} for {syn_spmms} "
        f"ELL SpMMs, obj {obj3!r}, "
        f"pinfeas {pinf3:.3e}, gap {gap3:.3e}, iterations {res3['iter']}, "
        f"majors {res3['majoriter']}, rank {res3['r']}, dual bounds "
        f"{res3['dual_bounds_computed']} with {res3['dual_passes']} block "
        f"passes at the final rank (the result's counts; over the whole "
        f"solve: block {bounds['block']} with {bounds['passes']} passes, "
        f"scalar {bounds['scalar']}, b {sorted(bounds['b'])}), "
        f"|obj - JAX|/|JAX| {rel3:.3e} (the committed "
        f"artifact: {rel3a:.3e}); float64 eigsh at the solver's multiplier: "
        f"lambda_min {lam_min64:.6e}, dual {dual64!r}, gap {gap64:.3e} "
        f"({eigsh_s:.1f} s); solve {syn_s:.3f} s")
    assert res3["inner_engine"] == ENGINE_FAST, res3["inner_engine"]
    assert syn_launches["K1"] == syn_launches["K2"] == 0, syn_launches
    assert syn_launches["gather_rows"] == syn_spmms > 0, (syn_launches,
                                                          syn_spmms)
    assert bounds["block"] > 0 and bounds["scalar"] == 0, bounds
    assert min(bounds["b"]) > 0 and res3["dual_passes"] > 0
    assert np.isfinite(obj3) and np.all(np.isfinite(res3["R"]))
    assert res3["R"].shape == (n_syn, res3["r"])
    assert pinf3 <= 1e-2 and gap3 <= 1e-2, (pinf3, gap3)
    assert rel3 <= 1e-2 and rel3a <= 1e-2, (obj3, rel3, rel3a)
    assert gap3 >= gap64 - 2e-3, (gap3, gap64)

    # ---- 11. gather times -------------------------------------------------
    spmm_rows = []
    for r in (10, 20):
        X = torch.randn((dp_syn.n_pad, r), generator=gen).to(dev)
        X[n_syn:] = 0.0
        ids = dp_syn.ell_ids     # one SpMM's gather: tier 1, then tier 2

        def kern():
            ga.gather_rows(X, ids)

        def plain():
            ga.gather_rows_plain(X, ids)

        def lib():
            torch.index_select(X, 0, ids)

        t = probes.time_in_turns(kern, plain, lib, reps=50)
        nidx = ids.numel()
        # int64 ids once, X once, the output once (X, 0.8 MB at r = 10,
        # stays in L2, so a row gathered again is no HBM traffic)
        nbytes = probes.gather_bytes(nidx, dp_syn.n_pad * r, nidx * r,
                                     idx_bytes=8)
        spmm_rows.append(dict(r=r, indices=nidx,
                              bound_ms=probes.bound_ms(nbytes), **t))
    probe_rows = probes.time_probes(reps=20)

    # where an iteration of the SYN20K solve goes: 40 inner steps of the
    # torch fast-diagonal loop at the solve's final factor (rank 20),
    # timed with CUDA events, with torch.profiler's device time by kernel
    from torch.profiler import ProfilerActivity, profile

    r_fin = res3["r"]
    R_fin = torch.zeros((dp_syn.n_pad, r_fin), device=dev)
    R_fin[:n_syn] = torch.tensor(res3["R"], device=dev)
    lam_fin = torch.tensor(res3["lambda_last"], dtype=torch.float32,
                           device=dev)
    sig_fin = torch.tensor(res3["sigma"], dtype=torch.float32, device=dev)
    L0s, vio0s, G0s, y0s, gn0s, _ = al_value_grad(dp_syn, R_fin, lam_fin,
                                                   sig_fin, True, True)

    def syn_steps(steps):
        c, _ = inner_chunk(dp_syn, R_fin, G0s, y0s, vio0s, L0s, gn0s,
                           lbfgs_init(K, dp_syn.n_pad, r_fin, torch.float32,
                                      dev),
                           lam_fin, sig_fin, -1.0, ninf, steps, k=K,
                           use_armijo=False, gtol_relative=True,
                           ptol_relative=True)
        assert c.steps == steps
        return c

    syn_steps(5)
    nsteps = 40
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    syn_steps(nsteps)
    e1.record()
    torch.cuda.synchronize()
    step_ms = e0.elapsed_time(e1) / nsteps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        syn_steps(nsteps)
        torch.cuda.synchronize()
        prof_wall_ms = (time.time() - t0) * 1e3
    # the kernels' own events (device type CUDA) only: an operator's
    # event carries the time of the kernels it launched too, and would
    # count it twice; the all-event sum is printed beside it
    dev_us, all_us = {}, 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        all_us += us
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.key] = us
    dev_total_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    busy = dev_total_ms / prof_wall_ms if prof_wall_ms > 0 else 0.0
    say("profile", f"SYN20K torch fast-diagonal inner loop at rank {r_fin}: "
        f"{step_ms:.3f} ms per iteration (CUDA events, {nsteps} steps); "
        f"under torch.profiler {prof_wall_ms / nsteps:.3f} ms per iteration "
        f"of host wall, {dev_total_ms / nsteps:.4f} ms of device kernel "
        f"time per iteration (device busy {busy:.3%}; all events, "
        f"operators included: {all_us / 1e3 / nsteps:.4f} ms); top "
        f"kernels by device time per iteration (us): "
        f"{json.dumps([(k[:60], round(v / nsteps, 2)) for k, v in top])}; "
        f"solve {syn_s:.3f} s over {res3['iter']} iterations = "
        f"{1e3 * syn_s / max(res3['iter'], 1):.3f} ms per iteration")
    # the gather end to end: the same work with the SpMM's row gather
    # through the kernel and through its plain version X[idx], in turns
    # (kernel, plain, plain, kernel): 40 steps of the SYN20K loop above
    # and the warm G1-shaped mu-conductance solve of phase 8, whose
    # scalar Lanczos passes are ELL SpMMs
    real_gather = spmm_mod.gather_rows

    def with_gather(fn, plain):
        spmm_mod.gather_rows = ga.gather_rows_plain if plain \
            else real_gather
        try:
            return fn()
        finally:
            spmm_mod.gather_rows = real_gather

    def loop_ms():
        torch.cuda.synchronize()
        e0.record()
        syn_steps(nsteps)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / nsteps

    def mucond_solve():
        t0 = time.time()
        r_ = sdplr(C2, As2, b2, RANK, **kw2)
        torch.cuda.synchronize()
        assert r_["primal_vio"] <= 1e-2 and r_["rel_duality_gap"] <= 1e-2
        return time.time() - t0, r_["iter"], r_["dual_passes"]

    swap = {w: {"syn20k_loop_ms": [], "mucond_s": [], "mucond_iters": []}
            for w in ("kernel", "plain")}
    for who in ("kernel", "plain", "plain", "kernel"):
        plain_g = who == "plain"
        swap[who]["syn20k_loop_ms"].append(with_gather(loop_ms, plain_g))
        sec, its, _ = with_gather(mucond_solve, plain_g)
        swap[who]["mucond_s"].append(sec)
        swap[who]["mucond_iters"].append(its)
    say("swap", f"the SpMM's row gather end to end, kernel against X[idx] "
        f"(turns kernel, plain, plain, kernel): {json.dumps(swap)}; "
        f"SYN20K loop at rank {r_fin} "
        f"{statistics.median(swap['kernel']['syn20k_loop_ms']):.3f} ms per "
        f"iteration with the kernel, "
        f"{statistics.median(swap['plain']['syn20k_loop_ms']):.3f} with "
        f"X[idx]; mu-conductance warm solve "
        f"{statistics.median(swap['kernel']['mucond_s']):.3f} s with the "
        f"kernel, {statistics.median(swap['plain']['mucond_s']):.3f} s "
        f"with X[idx]; nvidia-smi: {smi}")

    say("times3", f"gather_rows per SpMM at SYN20K shapes (one launch over "
        f"tier 1 + tier 2, int64 ids, float32): {json.dumps(spmm_rows)}; at "
        f"the probes' "
        f"shapes: {json.dumps(probe_rows)}; SYN20K solve {syn_s:.3f} s, "
        f"{res3['iter']} iterations, rank {res3['r']}, {bounds['block']} "
        f"block bounds with {bounds['passes']} passes (final rank: "
        f"{res3['dual_bounds_computed']} with {res3['dual_passes']}), "
        f"{syn_launches['gather_rows']} gather_rows launches "
        f"per solve ({syn_launches['gather_rows'] / max(res3['iter'], 1):.2f}"
        f" per iteration, {syn_spmms} ELL SpMMs); gather_rows launches on "
        f"the mu-conductance solve {rows2} ({spmms2} SpMMs); nvidia-smi: "
        f"{smi}")

    def probe_row(kernel):
        return next(p for p in probe_rows if p["kernel"] == kernel)

    kernels = [{
        "name": "K1 inner-loop megakernel (100 L-BFGS iterations, G1 shapes,"
                " float32)",
        "route": "cuda",
        "source": "sdplrplus_tpu_torch/csrc/megakernel.cu",
        "replaces": "sdplrplus_tpu/ops/megakernel.py:231",
        "launches": launches,
        "max_abs_err": worst[("G1-shaped MaxCut", "float32")],
        "ms": med["kernel"][0],
        "plain_ms": med["plain"][0],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "K2 Armijo inner-loop megakernel (100 L-BFGS iterations, "
                "mu-conductance G1 shapes, float32)",
        "route": "cuda",
        "source": "sdplrplus_tpu_torch/csrc/megakernel_armijo.cu",
        "replaces": "sdplrplus_tpu/ops/megakernel.py:485",
        "launches": launches2,
        "max_abs_err": worst2[(label, "float32")],
        "ms": med2["kernel"][0],
        "plain_ms": med2["plain"][0],
        "bound_ms": bound2_ms,
        "bound_by": bound2_by,
        "library_ms": None,
    }, {
        "name": "gather_rows (ELL row gather, one SpMM = tier 1 + tier 2, "
                "SYN20K shapes, r = 10, float32)",
        "route": "cuda",
        "source": "sdplrplus_tpu_torch/csrc/gather.cu",
        "replaces": "exps/probe3.py:97 (_full_take_call; also "
                    "exps/probe3.py:83, exps/probe_gather.py:66, "
                    "exps/probe5.py:42)",
        "launches": syn_launches["gather_rows"],
        "max_abs_err": gather_err["gather_rows"],
        "ms": spmm_rows[0]["kernel_ms"],
        "plain_ms": spmm_rows[0]["plain_ms"],
        "bound_ms": spmm_rows[0]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": spmm_rows[0]["library_ms"],
    }, {
        "name": "gather_window (window select, span 128, bucket 512, "
                "X (100000, 16), T = 2^19, float32; launches: probe entry "
                "point)",
        "route": "cuda",
        "source": "sdplrplus_tpu_torch/csrc/gather.cu",
        "replaces": "exps/probe2.py:104 (_onehot_call; also "
                    "exps/probe_gather.py:93)",
        "launches": probe_launches["gather_window"],
        "max_abs_err": gather_err["gather_window"],
        "ms": probe_row("gather_window")["kernel_ms"],
        "plain_ms": probe_row("gather_window")["plain_ms"],
        "bound_ms": probe_row("gather_window")["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "gather_lanes (take along rows, (4096, 1024) grid, float32; "
                "launches: probe entry point)",
        "route": "cuda",
        "source": "sdplrplus_tpu_torch/csrc/gather.cu",
        "replaces": "exps/probe3.py:48 (_lane_gather_call; also "
                    "exps/probe3.py:63)",
        "launches": probe_launches["gather_lanes"],
        "max_abs_err": gather_err["gather_lanes"],
        "ms": probe_row("gather_lanes")["kernel_ms"],
        "plain_ms": probe_row("gather_lanes")["plain_ms"],
        "bound_ms": probe_row("gather_lanes")["bound_ms"],
        "bound_by": "bytes",
        "library_ms": probe_row("gather_lanes")["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
