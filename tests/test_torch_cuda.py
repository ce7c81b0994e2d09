"""K1 and K2 on the card: each CUDA kernel against its plain version, and
solves served by them. Every test here needs an H100 and nvcc (marker
``cuda``) and skips elsewhere. The file imports no JAX, so it runs on a machine
that has only PyTorch (``--noconftest``: tests/conftest.py sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.compile import compile_problem
from sdplrplus_tpu_torch.models import problems
from sdplrplus_tpu_torch.ops import megakernel as mk
from sdplrplus_tpu_torch.ops.device import to_device
from sdplrplus_tpu_torch.problem import SDPProblem
from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init
from sdplrplus_tpu_torch.solver.outer import ENGINE_KERNEL

FAMILIES = ("maxcut", "minimum_bisection", "cutnorm")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture
def h100():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100) and nvcc")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (H100)")


def _run_on(device, problem, dtype, steps, n=200, r=10, k=4, seed=0):
    A = problems.make_random_graph(n, 0.5, seed=seed)
    C, As, b = getattr(problems, problem)(A)
    dp = to_device(compile_problem(SDPProblem(C, As, np.asarray(b, float),
                                              None), dense=True),
                   dtype, device)
    meta, data = mk.prepare_mega_data(dp, k=k, gtol_relative=True,
                                      ptol_relative=True)
    spec = mk.mega_spec_for(meta, r)
    rng = np.random.default_rng(seed + 1)
    R0 = np.zeros((dp.n_pad, r))
    R0[:n] = rng.uniform(-1, 1, (n, r))
    lam = 0.1 * rng.standard_normal(dp.m)
    t = lambda x: torch.tensor(x, dtype=dtype, device=device)
    # stagnation off (-inf): the comparison is at a fixed step count
    return mk.mega_chunk(spec, r, meta["m"], meta["pscale"], data, t(R0),
                         lbfgs_init(k, dp.n_pad, r, dtype, device), t(lam),
                         t(2.0), 1e-12, float("-inf"), steps)


@pytest.mark.cuda
@pytest.mark.parametrize("problem", FAMILIES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_matches_its_plain_version(h100, problem, dtype):
    td = DTYPES[dtype]
    before = mk.K1.launches
    ck, vk = _run_on("cuda", problem, td, 25)
    torch.cuda.synchronize()
    assert mk.K1.launches == before + 1
    cp, vp = _run_on("cpu", problem, td, 25)
    tol = 3e-3 if dtype == "float32" else 1e-9
    assert ck.steps == cp.steps == 25
    as_np = lambda x: x.detach().cpu().double().numpy()
    np.testing.assert_allclose(as_np(ck.R), as_np(cp.R), rtol=tol, atol=tol)
    np.testing.assert_allclose(as_np(ck.vio_raw), as_np(cp.vio_raw),
                               rtol=tol, atol=tol)
    assert abs(float(vk) - float(vp)) < tol * 10


@pytest.mark.cuda
def test_solve_on_the_card_runs_the_kernel(h100):
    A = problems.make_random_graph(200, 0.5, seed=1)
    C, As, b = problems.maxcut(A)
    before = mk.K1.launches
    res = sdplr(C, As, b, 10, ptol=1e-2, objtol=1e-2,
                prior_trace_bound=200.0, dtype="float32", seed=0,
                printlevel=0)
    assert res["inner_engine"] == ENGINE_KERNEL
    assert mk.K1.launches > before
    assert res["primal_vio"] <= 1e-2 and res["rel_duality_gap"] <= 1e-2
    ref = sdplr(C, As, b, 10, ptol=1e-2, objtol=1e-2,
                prior_trace_bound=200.0, dtype="float32", seed=0,
                printlevel=0, device="cpu")
    assert abs(res["obj"] - ref["obj"]) <= 1e-2 * abs(ref["obj"])


def _armijo_state(family, device, dtype, n=800, p=0.83, r=10, k=4, seed=0):
    """A K2 problem on a G1-shaped graph and an inner-loop state inside the
    feasible region's scale (as chip_smoke.py phase 6): μ-conductance
    (μ = 0.1) with R d-centred and scaled to ⟨D, X⟩ = 1, or relaxed MaxCut
    with native inequalities and rows of norm 1/1.01; small multipliers."""
    A = problems.make_random_graph(n, p, seed=1)
    if family == "mu_conductance_ineq":
        C, As, b, ct = problems.mu_conductance_ineq(A, 0.1)
    else:
        C, As, b, ct = problems.relaxed_maxcut_ineq(A)
    dp = to_device(compile_problem(SDPProblem(C, As, np.asarray(b, float),
                                              ct)), dtype, device)
    assert mk.megakernel_eligible(dp, r, k, True, dtype)
    meta, data = mk.prepare_mega_data(dp, k=k, gtol_relative=True,
                                      ptol_relative=True)
    spec = mk.mega_spec_for(meta, r)
    rng = np.random.default_rng(seed)
    Rn = rng.uniform(-1, 1, (n, r))
    if family == "mu_conductance_ineq":
        d = np.asarray(A.sum(axis=1)).reshape(-1)
        Rn -= np.outer(np.ones(n), d @ Rn / d.sum())
        Rn /= np.sqrt(np.sum(d * np.sum(Rn * Rn, axis=1)))
    else:
        Rn /= 1.01 * np.linalg.norm(Rn, axis=1, keepdims=True)
    R0 = np.zeros((dp.n_pad, r))
    R0[:n] = Rn
    lam = np.minimum(0.1 * rng.standard_normal(dp.m), dp.lam_ub.cpu().numpy())
    t = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return dp, meta, data, spec, t(R0), t(lam)


# float32 over 25 steps runs on relaxed MaxCut: on μ-conductance the
# Armijo test is decided below float32's resolution of the AL once α is
# ~2⁻²⁰ (the ddᵀ term makes it stiff), so two correct summation orders
# take adjacent halvings within 25 steps (chip_smoke.py phase 6 checks
# that case step by step)
@pytest.mark.cuda
@pytest.mark.parametrize("family,dtype,steps", [
    ("mu_conductance_ineq", "float64", 1),
    ("mu_conductance_ineq", "float64", 25),
    ("mu_conductance_ineq", "float32", 1),
    ("relaxed_maxcut_ineq", "float64", 25),
    ("relaxed_maxcut_ineq", "float32", 25),
])
def test_armijo_kernel_matches_its_plain_version(h100, family, dtype, steps):
    td = DTYPES[dtype]
    r, k = 10, 4
    out = {}
    for device in ("cuda", "cpu"):
        dp, meta, data, spec, R, lam = _armijo_state(family, device, td)
        assert spec.armijo
        before = mk.K2.launches
        out[device] = mk.mega_chunk(
            spec, r, meta["m"], meta["pscale"], data, R,
            lbfgs_init(k, dp.n_pad, r, td, device), lam,
            torch.tensor(2.0, dtype=td, device=device), 1e-12, float("-inf"),
            steps)
        torch.cuda.synchronize()
        assert mk.K2.launches == before + (device == "cuda")
    (ck, vk), (cp, vp) = out["cuda"], out["cpu"]
    # float32: the tolerances of K1's comparisons (tests/test_megakernel.py)
    tol = (1e-4 if steps == 1 else 3e-3) if dtype == "float32" else 1e-9
    assert ck.steps == cp.steps == steps
    as_np = lambda x: x.detach().cpu().double().numpy()
    assert abs(float(ck.L_val) - float(cp.L_val)) \
        / (abs(float(cp.L_val)) + 1) < tol
    np.testing.assert_allclose(as_np(ck.R), as_np(cp.R), rtol=tol,
                               atol=tol * 10)
    np.testing.assert_allclose(as_np(ck.vio_raw), as_np(cp.vio_raw),
                               rtol=tol, atol=tol * 10)
    assert abs(float(vk) - float(vp)) < tol * 10


@pytest.mark.cuda
def test_mucond_solve_on_the_card_runs_k2(h100):
    A = problems.make_random_graph(200, 0.5, seed=1)
    C, As, b, ct = problems.mu_conductance_ineq(A, 0.1)
    tb = 200 * problems.mu_conductance_ub(float(A.sum()), 0.1)
    kw = dict(constraint_types=ct, ptol=1e-2, objtol=1e-2,
              prior_trace_bound=tb, dtype="float32", seed=0, printlevel=0)
    k1, k2 = mk.K1.launches, mk.K2.launches
    res = sdplr(C, As, b, 10, **kw)
    assert res["inner_engine"] == ENGINE_KERNEL
    assert mk.K2.launches > k2 and mk.K1.launches == k1
    assert res["primal_vio"] <= 1e-2 and res["rel_duality_gap"] <= 1e-2
    ref = sdplr(C, As, b, 10, device="cpu", **kw)
    assert abs(res["obj"] - ref["obj"]) <= 1e-2 * abs(ref["obj"])
