"""K1, the inner-loop megakernel: its plain version against the JAX
package's Pallas kernel run in interpret mode, and against the JAX
package's XLA dense inner loop in the compact L-BFGS form, which K1 and
its plain version follow.

On the CPU ``mega_chunk`` runs ``mega_chunk_plain``, the kernel's loop
written step by step in torch; the CUDA kernel itself only runs on an
H100 (tests/test_torch_cuda.py, which imports no JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdplrplus_tpu.compile import compile_problem as j_compile
from sdplrplus_tpu.models import problems as j_models
from sdplrplus_tpu.ops.device import to_device as j_to_device
from sdplrplus_tpu.ops.megakernel import make_mega_inner_chunk
from sdplrplus_tpu.problem import SDPProblem as JProblem
from sdplrplus_tpu.solver.al import al_value_grad as j_al_value_grad
from sdplrplus_tpu.solver.inner import inner_chunk as j_inner_chunk
from sdplrplus_tpu.solver.lbfgs import lbfgs_init as j_lbfgs_init

from sdplrplus_tpu_torch.compile import compile_problem as t_compile
from sdplrplus_tpu_torch.models import problems as t_models
from sdplrplus_tpu_torch.ops import megakernel as mk
from sdplrplus_tpu_torch.ops.device import to_device as t_to_device
from sdplrplus_tpu_torch.problem import SDPProblem as TProblem
from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init as t_lbfgs_init

FAMILIES = {"maxcut": "maxcut", "minbis": "minimum_bisection",
            "cutnorm": "cutnorm"}
DT = {"float32": (jnp.float32, torch.float32),
      "float64": (jnp.float64, torch.float64)}


def _setup(problem="maxcut", dtype="float32", n=24, p=0.5, r=3, seed=0,
           device="cpu"):
    A = j_models.make_random_graph(n, p, seed=seed)
    gen = FAMILIES[problem]
    Cj, Asj, bj = getattr(j_models, gen)(A)
    Ct, Ast, bt = getattr(t_models, gen)(A)
    jd, td = DT[dtype]
    dp_j = j_to_device(j_compile(JProblem(Cj, Asj, np.asarray(bj, float),
                                          None), dense=True), jd)
    dp_t = t_to_device(t_compile(TProblem(Ct, Ast, np.asarray(bt, float),
                                          None), dense=True), td, device)
    rng = np.random.default_rng(seed + 1)
    R0 = np.zeros((dp_j.n_pad, r))
    R0[: dp_j.n] = rng.uniform(-1, 1, (dp_j.n, r))
    lam = rng.standard_normal(dp_j.m) * 0.1
    return dp_j, dp_t, R0, lam


def _port_run(dp_t, k, r):
    meta, data = mk.prepare_mega_data(dp_t, k=k, gtol_relative=True,
                                      ptol_relative=True)
    spec = mk.mega_spec_for(meta, r)

    def run(R, lbfgs, lam, sigma, gtol, stag, steps):
        return mk.mega_chunk(spec, r, meta["m"], meta["pscale"], data, R,
                             lbfgs, lam, sigma, gtol, stag, steps)
    return run


def _xla_run(dp_j, R0, lam, k, steps, stag, compact, jd):
    """The JAX package's XLA dense inner loop (two-loop or compact L-BFGS
    direction) from R0, an empty ring of k slots and σ = 2."""
    f = lambda x: jnp.asarray(x, jd)
    r = R0.shape[1]
    L0, vio0, G0, y0, gn0, _ = j_al_value_grad(dp_j, f(R0), f(lam), f(2.0),
                                               True, True)
    return j_inner_chunk(
        dp_j, f(R0), G0, y0, vio0, L0, gn0,
        j_lbfgs_init(k, dp_j.n_pad, r, jd), f(lam), f(2.0), f(1e-12),
        f(stag), steps, k=k, use_armijo=False, gtol_relative=True,
        ptol_relative=True, lbfgs_compact=compact)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _tt(x, dtype, device="cpu"):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


@pytest.mark.parametrize("problem", sorted(FAMILIES))
@pytest.mark.parametrize("k", [4, 0])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_version_matches_the_pallas_kernel(problem, k, dtype):
    jd, td = DT[dtype]
    dp_j, dp_t, R0, lam = _setup(problem, dtype)
    r = R0.shape[1]
    assert mk.megakernel_eligible(dp_t, r, k, False, td)
    run_j = make_mega_inner_chunk(dp_j, k=k, gtol_relative=True,
                                  ptol_relative=True, interpret=True)(r)
    run_t = _port_run(dp_t, k, r)
    launches = mk.K1.launches
    stag = 0.0
    for steps in (1, 25):
        cj, vj = run_j(jnp.asarray(R0, jd), j_lbfgs_init(max(k, 1), dp_j.n_pad,
                                                         r, jd),
                       jnp.asarray(lam, jd), jnp.asarray(2.0, jd),
                       jnp.asarray(1e-12, jd), jnp.asarray(stag, jd),
                       jnp.asarray(steps, jnp.int32))
        ct, vt = run_t(_tt(R0, td), t_lbfgs_init(max(k, 1), dp_t.n_pad, r,
                                                  td),
                       _tt(lam, td), _tt(2.0, td), 1e-12, stag, steps)
        assert ct.steps == int(cj.steps) == steps
        if (problem, k, dtype, steps) == ("cutnorm", 4, "float32", 25):
            # the plain version takes the compact L-BFGS direction, the
            # Pallas kernel the two-loop one; in float32 on CutNorm the
            # plain version, like the JAX package's XLA loop in both
            # forms, meets rel ΔL < 0 at step 25 (one rounding of L_new
            # near -773.5) and the Pallas kernel at step 26, so the flag
            # is held against the XLA loops here
            assert ct.stagnated and not bool(cj.stagnated)
            for compact in (True, False):
                cx, _ = _xla_run(dp_j, R0, lam, k, steps, stag, compact, jd)
                assert int(cx.steps) == steps and bool(cx.stagnated)
        else:
            assert ct.stagnated == bool(cj.stagnated)
        if dtype == "float64":
            tol = 1e-9
            for name in ("R", "G", "vio_raw", "y_full", "L_val",
                         "grad_norm"):
                np.testing.assert_allclose(
                    _np(getattr(ct, name)), _np(getattr(cj, name)),
                    rtol=tol, atol=tol, err_msg=f"{name} after {steps}")
            for name in ("s_hist", "y_hist", "rho"):
                np.testing.assert_allclose(
                    _np(getattr(ct.lbfgs, name)),
                    _np(getattr(cj.lbfgs, name)), rtol=tol, atol=tol,
                    err_msg=name)
            assert ct.lbfgs.head == int(cj.lbfgs.head)
            assert abs(float(vt) - float(vj)) < tol
        else:
            # the tolerances of tests/test_megakernel.py:81
            tol = 1e-4 if steps == 1 else 3e-3
            scale = abs(float(cj.L_val)) + 1.0
            assert abs(float(ct.L_val) - float(cj.L_val)) / scale < tol
            np.testing.assert_allclose(_np(ct.R), _np(cj.R), rtol=tol,
                                       atol=tol * 10)
            np.testing.assert_allclose(_np(ct.vio_raw), _np(cj.vio_raw),
                                       rtol=tol, atol=tol * 10)
            assert abs(float(vt) - float(vj)) < tol * 10
            assert abs(float(ct.grad_norm) - float(cj.grad_norm)) \
                / (float(cj.grad_norm) + 1e-9) < 0.05
    assert mk.K1.launches == launches   # CPU tensors never launch K1


@pytest.mark.parametrize("problem", sorted(FAMILIES))
@pytest.mark.parametrize("steps", [1, 25])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_version_matches_the_compact_xla_loop(problem, steps, dtype):
    """K1's plain version (the compact direction on Grams built from the
    ring at entry and refreshed on every push) against the JAX package's
    XLA dense inner loop with ``lbfgs_compact=True``, k = 4, with the
    stagnation test on (tolerance 0): the same steps and stagnation exit,
    float64 to 1e-9, the Grams it returns equal to those ``lbfgs_push``
    kept; float32 to the Pallas comparison's tolerances."""
    k = 4
    jd, td = DT[dtype]
    dp_j, dp_t, R0, lam = _setup(problem, dtype)
    r = R0.shape[1]
    cj, vj = _xla_run(dp_j, R0, lam, k, steps, 0.0, True, jd)
    ct, vt = _port_run(dp_t, k, r)(
        _tt(R0, td), t_lbfgs_init(k, dp_t.n_pad, r, td), _tt(lam, td),
        _tt(2.0, td), 1e-12, 0.0, steps)
    assert ct.steps == int(cj.steps) == steps
    assert ct.stagnated == bool(cj.stagnated)
    assert ct.lbfgs.head == int(cj.lbfgs.head)
    if dtype == "float64":
        tol = 1e-9
        for name in ("R", "G", "vio_raw", "y_full", "L_val", "grad_norm"):
            np.testing.assert_allclose(_np(getattr(ct, name)),
                                       _np(getattr(cj, name)), rtol=tol,
                                       atol=tol,
                                       err_msg=f"{name} after {steps}")
        for name in ("s_hist", "y_hist", "rho", "sty", "yty"):
            np.testing.assert_allclose(_np(getattr(ct.lbfgs, name)),
                                       _np(getattr(cj.lbfgs, name)),
                                       rtol=tol, atol=tol, err_msg=name)
        assert abs(float(vt) - float(vj)) < tol
    else:
        tol = 1e-4 if steps == 1 else 3e-3
        scale = abs(float(cj.L_val)) + 1.0
        assert abs(float(ct.L_val) - float(cj.L_val)) / scale < tol
        for a, b in ((ct.R, cj.R), (ct.vio_raw, cj.vio_raw)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=tol,
                                       atol=tol * 10)
        assert abs(float(vt) - float(vj)) < tol * 10


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_version_takes_any_ring_at_entry(dtype):
    """K1 rebuilds SᵀY and YᵀY from the ring at entry, so a ring whose
    Grams were not kept (the state the two-loop design left: zeros) or one
    that is only partly filled gives the same steps as the ring the
    kernel itself returned: 2 + 3 steps, with the Grams dropped between
    them, equal 5 (empty slots, ρ = 0, are masked by age from head)."""
    jd, td = DT[dtype]
    dp_j, dp_t, R0, lam = _setup("minbis", dtype)
    r, k = R0.shape[1], 4
    run_t = _port_run(dp_t, k, r)
    Rt, lt, st = _tt(R0, td), _tt(lam, td), _tt(2.0, td)
    c2, _ = run_t(Rt, t_lbfgs_init(k, dp_t.n_pad, r, td), lt, st, 1e-12,
                  -np.inf, 2)
    assert c2.lbfgs.head == 2 and int(torch.sum(c2.lbfgs.rho != 0)) == 2
    gram = torch.stack([c2.lbfgs.sty, c2.lbfgs.yty])
    assert float(gram.abs().max()) > 0.0
    c2.lbfgs.sty.zero_()
    c2.lbfgs.yty.zero_()
    c23, _ = run_t(c2.R, c2.lbfgs, lt, st, 1e-12, -np.inf, 3)
    c5, _ = run_t(Rt, t_lbfgs_init(k, dp_t.n_pad, r, td), lt, st, 1e-12,
                  -np.inf, 5)
    atol = 1e-4 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(_np(c23.R), _np(c5.R), rtol=0, atol=atol)
    np.testing.assert_allclose(_np(c23.lbfgs.sty), _np(c5.lbfgs.sty),
                               rtol=atol, atol=atol)
    assert c23.lbfgs.head == c5.lbfgs.head == 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_version_gtol_exit_and_ring_round_trip(dtype):
    """5 + 5 steps equal 10 (the ring round-trips through LBFGSState),
    and a loose gtol exits early — in both packages alike."""
    jd, td = DT[dtype]
    dp_j, dp_t, R0, lam = _setup("maxcut", dtype)
    r, k = R0.shape[1], 4
    run_j = make_mega_inner_chunk(dp_j, k=k, gtol_relative=True,
                                  ptol_relative=True, interpret=True)(r)
    run_t = _port_run(dp_t, k, r)
    Rt, lt, st = _tt(R0, td), _tt(lam, td), _tt(2.0, td)
    lb = t_lbfgs_init(k, dp_t.n_pad, r, td)
    c1, _ = run_t(Rt, lb, lt, st, 1e-12, 0.0, 5)
    c2, _ = run_t(c1.R, c1.lbfgs, lt, st, 1e-12, 0.0, 5)
    c10, _ = run_t(Rt, lb, lt, st, 1e-12, 0.0, 10)
    assert c2.steps == 5 and c10.steps == 10
    atol = 2e-3 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(_np(c2.R), _np(c10.R), rtol=0, atol=atol)
    rel = abs(float(c2.L_val) - float(c10.L_val)) / (abs(float(c10.L_val))
                                                     + 1)
    assert rel < (1e-3 if dtype == "float32" else 1e-10)
    j10, _ = run_j(jnp.asarray(R0, jd), j_lbfgs_init(k, dp_j.n_pad, r, jd),
                   jnp.asarray(lam, jd), jnp.asarray(2.0, jd), 1e-12, 0.0, 10)
    np.testing.assert_allclose(_np(c2.R), _np(j10.R), rtol=0,
                               atol=atol * (5 if dtype == "float32" else 10))

    c_e, _ = run_t(Rt, lb, lt, st, 1e-1, 0.0, 10000)
    j_e, _ = run_j(jnp.asarray(R0, jd), j_lbfgs_init(k, dp_j.n_pad, r, jd),
                   jnp.asarray(lam, jd), jnp.asarray(2.0, jd), 1e-1, 0.0,
                   10000)
    assert c_e.steps < 10000 and float(c_e.grad_norm) <= 1e-1
    assert c_e.steps == int(j_e.steps)


def test_quartic_of_the_kernel_matches_ops_cubic():
    from sdplrplus_tpu_torch.ops.cubic import minimize_quartic

    rng = np.random.default_rng(5)
    for _ in range(200):
        coeffs = rng.standard_normal(5) * 10.0 ** rng.integers(-3, 4, 5)
        coeffs[4] = abs(coeffs[4])          # the AL restriction: a ≥ 0
        ct = [torch.tensor(c, dtype=torch.float64) for c in coeffs]
        a_k, f_k = mk.minimize_quartic_kernel(*ct, 1.0,
                                              torch.finfo(torch.float64).eps)
        a_c, f_c = minimize_quartic(tuple(ct), 1.0)
        assert float(f_k) <= float(f_c) + 1e-9 * (abs(float(f_c)) + 1.0)


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    dp_j, dp_t, R0, lam = _setup("maxcut")
    meta, data = mk.prepare_mega_data(dp_t, k=4, gtol_relative=True,
                                      ptol_relative=True)
    spec = mk.mega_spec_for(meta, 3)
    x = torch.zeros((spec.rp, spec.n_pad))
    with pytest.raises(ValueError, match="CUDA"):
        mk.mega_kernel(spec, torch.zeros(9), data.C, x, x[:1], x[:1], x[:1],
                       x.repeat(4, 1), x.repeat(4, 1), data.lr_B,
                       data.lr_Bdt, data.lr_d)


@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_eligibility_and_layout_limits(problem):
    from sdplrplus_tpu.ops.megakernel import megakernel_eligible

    dp_j, dp_t, _, _ = _setup(problem)
    assert mk.megakernel_eligible(dp_t, 3, 4, False, torch.float32)
    # an Armijo request routes to K2, as in the JAX package
    assert mk.megakernel_eligible(dp_t, 3, 4, True, torch.float32) \
        == megakernel_eligible(dp_j, 3, 4, True, jnp.float32)
    assert not mk.megakernel_eligible(dp_t, 3, 4, False, torch.bfloat16)
    assert not mk.megakernel_eligible(dp_t, mk.MAX_RP + 1, 4, False,
                                      torch.float32)
    assert not mk.megakernel_eligible(dp_t, 3, mk.MAX_K + 1, False,
                                      torch.float32)
    # K1 reads the ring from L2 where its slab does not fit, so every rank
    # and ring length within the layout's limits stays eligible
    for dtype in (torch.float32, torch.float64):
        for r in (1, 20, 41, mk.MAX_RP):
            for k in (1, 4, 8, mk.MAX_K):
                assert mk.megakernel_eligible(dp_t, r, k, False, dtype), \
                    (dtype, r, k)


def test_k1_smem_plan_fits_every_shape_within_the_layout():
    """k1_smem_plan finds a launch for every n_pad ≤ 2048, rp ≤ 64, k ≤ 16
    and lrc ≤ 8 in both dtypes, keeps C's slab resident in float32 up to
    n_pad 2048 and in float64 up to 896 at the G1 state's rank and ring,
    and drops the ring's slab before C's."""
    for itemsize in (4, 8):
        for n_pad in range(64, mk.MAX_N_PAD + 1, 64):
            for rp in range(8, mk.MAX_RP + 1, 8):
                for k in range(1, mk.MAX_K + 1):
                    for lrc in range(mk.MAX_LR_COLS + 1):
                        plan = mk.k1_smem_plan(n_pad, rp, k, lrc, itemsize)
                        assert plan is not None, (n_pad, rp, k, lrc)
                        assert plan[0] <= mk.SMEM_MAX
                        assert plan[0] == mk.k1_smem_bytes(
                            n_pad, rp, k, lrc, itemsize, plan[1], plan[2])
    assert mk.k1_smem_plan(2048, 16, 4, 0, 4)[1:] == (True, True)
    assert mk.k1_smem_plan(896, 16, 4, 1, 8)[1:] == (True, True)
    assert mk.k1_smem_plan(2048, 16, 4, 0, 8)[1] is False
    # float64, rank 64, 16 slots: neither C's slab nor the ring's fits
    assert mk.k1_smem_plan(2048, 64, 16, 8, 8)[1:] == (False, False)
    assert mk.k1_smem_plan(2048, 64, 16, 0, 4)[1:] == (True, False)


def test_lovasz_theta_is_not_eligible():
    A = j_models.make_random_graph(16, 0.4, seed=1)
    C, As, b = t_models.lovasz_theta(A)
    cp = t_compile(TProblem(C, As, np.asarray(b, float), None), entry=False)
    dp = t_to_device(cp, torch.float32, "cpu")
    assert not mk.megakernel_eligible(dp, 3, 4, False, torch.float32)



@pytest.mark.parametrize("family", ["minimum_bisection", "maxcut"])
def test_plain_version_within_rounding_of_the_extended_evaluation(family):
    """K1's loop in float64 (the plain version) against the same loop in
    longdouble on the host (ops/megakernel_ext.py), at r = 64, k = 16
    (the card test's hardest shape), steps 0..5: every entry of G within
    a few units (8) of its float64 rounding scale eps·G_scale (the
    worst-case bound of a length-n sum is about n/2 such units, 128 here;
    MaxCut's first gradient measures 3.1), and R and the violations to
    1e-9. The card test holds K1 to the same."""
    from sdplrplus_tpu_torch.ops import megakernel_ext as mx

    for steps in range(6):
        spec, args, _, _ = mx.k1_case("cpu", family, steps)
        ext = mx.mega_chunk_ext(spec, *args)
        assert len(ext["alphas"]) == steps
        rep = mx.rounding_report(ext, mk.mega_chunk_plain(spec, *args))
        assert rep["dG_in_scale_units"] <= 8.0, (steps, rep)
        assert rep["max_dR"] <= 1e-9 and rep["max_dvio"] <= 1e-9, rep
