"""K1, the inner-loop megakernel: its plain version against the JAX
package's Pallas kernel run in interpret mode.

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
    for steps in (1, 25):
        cj, vj = run_j(jnp.asarray(R0, jd), j_lbfgs_init(max(k, 1), dp_j.n_pad,
                                                         r, jd),
                       jnp.asarray(lam, jd), jnp.asarray(2.0, jd),
                       jnp.asarray(1e-12, jd), jnp.asarray(0.0, jd),
                       jnp.asarray(steps, jnp.int32))
        ct, vt = run_t(_tt(R0, td), t_lbfgs_init(max(k, 1), dp_t.n_pad, r,
                                                  td),
                       _tt(lam, td), _tt(2.0, td), 1e-12, 0.0, steps)
        assert ct.steps == int(cj.steps) == steps
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


def test_lovasz_theta_is_not_eligible():
    A = j_models.make_random_graph(16, 0.4, seed=1)
    C, As, b = t_models.lovasz_theta(A)
    cp = t_compile(TProblem(C, As, np.asarray(b, float), None), entry=False)
    dp = t_to_device(cp, torch.float32, "cpu")
    assert not mk.megakernel_eligible(dp, 3, 4, False, torch.float32)

