#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one H100, the CUDA
toolkit and PyTorch built for CUDA. It builds the port's CUDA kernel
from the sources in the checkout and runs these phases, one line each:

  1. device   the card, its compute capability (must be 9.0), its name
              and power limit as nvidia-smi reports them, the TF32 flags;
  2. build    nvcc of csrc/megakernel.cu, in seconds, and what ptxas
              reports of its registers and spills;
  3. K1       the inner-loop megakernel against its plain PyTorch version
              on the same inputs on the card: float32 and float64, 1 and
              25 steps, the gtol exit and the ring round trip, on a
              G1-shaped MaxCut (n_pad 896), MinBisection on the same
              graph (one low-rank term) and a G22-shaped MaxCut
              (n_pad 2048), all at rank 10;
  4. slice    the main path: sdplr(...) on the G1-shaped MaxCut in
              float32, with every launch count set to 0 just before and
              read just after; it must run on K1, reach pinfeas and gap
              ≤ 1e-2, and land within 1e-2 of the JAX package's objective;
  5. times    CUDA-event times in turns (plain, kernel, kernel, plain):
              K1 per iteration (the slope between 100 and 2000 steps with
              gtol -1 and the stagnation test off), its plain version's
              and the torch inner loop's per iteration, the bound, and the
              warm solve's seconds after one warm-up solve.

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

# sdplrplus_tpu.sdplr (the JAX package) on the CPU, float32, on the same
# instance and arguments as phase 4:
#   A = make_random_graph(800, 0.83, seed=1); C, As, b = maxcut(A)
#   sdplr(C, As, b, 10, ptol=1e-2, objtol=1e-2, prior_trace_bound=800.0,
#         dtype="float32", seed=0)
# -> obj -11819.0537109375, pinfeas 9.64e-3, gap 2.80e-3, 158 iterations,
#    rank 10, engine dense-mxu.
JAX_G1_OBJ = -11819.0537109375

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
        make_random_graph, maxcut, minimum_bisection,
    )
    from sdplrplus_tpu_torch.ops import megakernel as mk
    from sdplrplus_tpu_torch.ops.device import to_device
    from sdplrplus_tpu_torch.problem import SDPProblem
    from sdplrplus_tpu_torch.solver.al import al_value_grad
    from sdplrplus_tpu_torch.solver.inner import inner_chunk
    from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init
    from sdplrplus_tpu_torch.solver.outer import ENGINE_KERNEL

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

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    built = mk.K1.built
    build_s = time.time() - t0
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", f"{os.path.relpath(built.path)} in {build_s:.1f} s "
        f"(cached={built.cached}); ptxas: {' / '.join(ptxas)}")

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
    # differs between two correct float32 summation orders.
    ninf = float("-inf")
    worst = {}
    for label, _, _ in cases:
        for dname, dtype in (("float32", torch.float32),
                             ("float64", torch.float64)):
            dp, meta, data, spec, R, lam, sigma = kernel_state(label, dtype)
            lb = lbfgs_init(K, dp.n_pad, RANK, dtype, dev)
            errs = []
            for steps in (1, 25):
                ck, vk = run_k1("kernel", spec, meta, data, R, lb, lam,
                                sigma, 1e-12, ninf, steps)
                cp, vp = run_k1("plain", spec, meta, data, R, lb, lam,
                                sigma, 1e-12, ninf, steps)
                assert ck.steps == cp.steps == steps, (ck.steps, cp.steps)
                tol = (1e-4 if steps == 1 else 3e-3) \
                    if dname == "float32" else 1e-9
                Lk, Lp = float(ck.L_val), float(cp.L_val)
                assert np.isfinite(Lk) and abs(Lk - Lp) / (abs(Lp) + 1) \
                    < tol, (label, dname, steps, Lk, Lp)
                err = float(np.max(np.abs(as_np(ck.R) - as_np(cp.R))))
                np.testing.assert_allclose(as_np(ck.R), as_np(cp.R),
                                           rtol=tol, atol=tol * 10)
                np.testing.assert_allclose(as_np(ck.vio_raw),
                                           as_np(cp.vio_raw), rtol=tol,
                                           atol=tol * 10)
                assert abs(float(vk) - float(vp)) < tol * 10
                assert abs(float(ck.grad_norm) - float(cp.grad_norm)) \
                    / (float(cp.grad_norm) + 1e-9) < 0.05
                if dname == "float64":
                    for a, b_ in ((ck.G, cp.G), (ck.lbfgs.s_hist,
                                                 cp.lbfgs.s_hist),
                                  (ck.lbfgs.y_hist, cp.lbfgs.y_hist)):
                        np.testing.assert_allclose(as_np(a), as_np(b_),
                                                   rtol=tol, atol=tol)
                    assert ck.lbfgs.head == cp.lbfgs.head
                errs.append(err)
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
                f"1 and 25 steps agree (max |ΔR| {max(errs):.3e}), "
                f"5+5 = 10 steps, gtol exit after {ce.steps} (plain "
                f"{pe.steps}) steps")

    # ---- 4. the slice ------------------------------------------------------
    A = g800
    C, As, b = maxcut(A)
    kw = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=800.0,
              dtype="float32", seed=0, printlevel=0)
    mk.K1.launches = 0
    t0 = time.time()
    res = sdplr(C, As, b, RANK, **kw)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    launches = mk.K1.launches
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
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
