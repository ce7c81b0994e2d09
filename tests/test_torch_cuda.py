"""The CUDA kernels on the card: K1, K2 and the three gather kernels
against their plain versions, and solves served by them. Every test here
needs an H100 and nvcc (marker ``cuda``) and skips elsewhere. The file imports no JAX, so it runs on a machine
that has only PyTorch (``--noconftest``: tests/conftest.py sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.compile import compile_problem
from sdplrplus_tpu_torch.models import problems
from sdplrplus_tpu_torch.ops import gather as ga
from sdplrplus_tpu_torch.ops import megakernel as mk
from sdplrplus_tpu_torch.ops.spmm import spmm_C
from sdplrplus_tpu_torch.ops.device import to_device
from sdplrplus_tpu_torch.problem import SDPProblem
from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init
from sdplrplus_tpu_torch.solver.outer import ENGINE_FAST, ENGINE_KERNEL

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
@pytest.mark.parametrize("r,k", [(10, 4), (64, 16)])
def test_cuda_kernel_matches_its_plain_version_step_by_step(h100, r, k):
    """K1 in float64 at every step count 0..25 against its plain version
    on the CPU: R and the violations to 1e-9, G, the ring and the Grams
    to 1e-9 of their largest entry (MinBisection from an uncentred R puts
    entries of ~1e2 into G, whose last bits the card's and the CPU's
    summation orders set differently); at r = 64 and 16 slots the ring's
    slab does not fit in shared memory and the kernel reads it from L2."""
    plan = mk.k1_smem_plan(256, r, k, 1, 8, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert plan[2] == (r == 10), plan
    as_np = lambda x: x.detach().cpu().double().numpy()
    for steps in range(26):
        ck, vk = _run_on("cuda", "minimum_bisection", torch.float64, steps,
                         r=r, k=k)
        cp, vp = _run_on("cpu", "minimum_bisection", torch.float64, steps,
                         r=r, k=k)
        assert ck.steps == cp.steps == steps
        for a, b in ((ck.R, cp.R), (ck.vio_raw, cp.vio_raw)):
            np.testing.assert_allclose(as_np(a), as_np(b), rtol=1e-9,
                                       atol=1e-9, err_msg=str(steps))
        for a, b in ((ck.G, cp.G), (ck.lbfgs.s_hist, cp.lbfgs.s_hist),
                     (ck.lbfgs.y_hist, cp.lbfgs.y_hist),
                     (ck.lbfgs.sty, cp.lbfgs.sty),
                     (ck.lbfgs.yty, cp.lbfgs.yty)):
            ref = max(float(np.max(np.abs(as_np(b)))), 1.0)
            assert np.max(np.abs(as_np(a) - as_np(b))) <= 1e-9 * ref, steps
        assert ck.lbfgs.head == cp.lbfgs.head
        assert abs(float(vk) - float(vp)) < 1e-9


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
@pytest.mark.parametrize("family", ["mu_conductance_ineq",
                                    "relaxed_maxcut_ineq"])
def test_armijo_kernel_matches_its_plain_version_step_by_step(h100, family):
    """K2 against its plain version (run on the card too, from the same
    inputs) at every step count 0..25 in float64 to 1e-9, with the same α
    at every step and the Grams SᵀY, YᵀY it returns held as the ring is;
    in float32 at steps 0 and 1 to K1's tolerance (1e-4)."""
    r, k = 10, 4
    for dname, last in (("float64", 25), ("float32", 1)):
        td = DTYPES[dname]
        dp, meta, data, spec, R, lam = _armijo_state(family, "cuda", td)
        sigma = torch.tensor(2.0, dtype=td, device="cuda")
        as_np = lambda x: x.detach().cpu().double().numpy()
        for steps in range(last + 1):
            out = {}
            for fn in (mk.mega_kernel_armijo, mk.mega_chunk_armijo_plain):
                args = mk.mega_inputs(spec, r, data, R,
                                      lbfgs_init(k, dp.n_pad, r, td, "cuda"),
                                      lam, sigma, 1e-12, float("-inf"), steps)
                o = fn(spec, *args)
                torch.cuda.synchronize()
                out[fn] = (mk.mega_carry(spec, r, meta["m"], meta["pscale"],
                                         data, lam, sigma,
                                         *mk.rings_of(spec, args), o),
                           float(o[3][5]))
            ((ck, vk), ak), ((cp, vp), ap) = out.values()
            assert ck.steps == cp.steps == steps and ak == ap
            tol = 1e-9 if dname == "float64" else 1e-4
            assert abs(float(ck.L_val) - float(cp.L_val)) \
                / (abs(float(cp.L_val)) + 1) < tol
            np.testing.assert_allclose(as_np(ck.R), as_np(cp.R), rtol=tol,
                                       atol=tol * 10)
            np.testing.assert_allclose(as_np(ck.vio_raw), as_np(cp.vio_raw),
                                       rtol=tol, atol=tol * 10)
            assert abs(float(vk) - float(vp)) < tol * 10
            if dname == "float64":
                for a, b in ((ck.lbfgs.s_hist, cp.lbfgs.s_hist),
                             (ck.lbfgs.y_hist, cp.lbfgs.y_hist),
                             (ck.lbfgs.sty, cp.lbfgs.sty),
                             (ck.lbfgs.yty, cp.lbfgs.yty)):
                    ref = np.max(np.abs(as_np(b)))
                    assert np.max(np.abs(as_np(a) - as_np(b))) <= 1e-5 * ref
                assert ck.lbfgs.head == cp.lbfgs.head


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


# ---- the gather kernels (csrc/gather.cu): a gather is exact ----------------

IDX = {"int32": torch.int32, "int64": torch.int64}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("idx", sorted(IDX))
@pytest.mark.parametrize("r,q", [(10, 1), (20, 1), (16, 8), (3, 2)])
def test_gather_rows_matches_its_plain_version(h100, dtype, idx, r, q):
    g = torch.Generator().manual_seed(r * q)
    X = torch.randn((5000, r), generator=g, dtype=DTYPES[dtype]).cuda()
    i = torch.randint(0, 5000 // q, (7777,), generator=g).to(IDX[idx]).cuda()
    before = ga.ROWS.launches
    got = ga.gather_rows(X, i, q)
    torch.cuda.synchronize()
    assert ga.ROWS.launches == before + 1
    assert torch.equal(got, ga.gather_rows_plain(X, i, q))


@pytest.mark.cuda
@pytest.mark.parametrize("span,bucket", [(128, 512), (1024, 512), (7, 3)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_window_matches_its_plain_version(h100, span, bucket, dtype):
    g = torch.Generator().manual_seed(span)
    X = torch.randn((10_000, 16), generator=g, dtype=DTYPES[dtype]).cuda()
    nt = 37
    wins = torch.randint(0, 10_000 // span, (nt,), generator=g).cuda()
    offs = torch.randint(0, span, (nt, bucket), generator=g).cuda()
    before = ga.WINDOW.launches
    got = ga.gather_window(X, wins, offs, span, bucket)
    torch.cuda.synchronize()
    assert ga.WINDOW.launches == before + 1
    assert torch.equal(got, ga.gather_window_plain(X, wins, offs, span,
                                                   bucket))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [10, 16, 32, 3])
@pytest.mark.parametrize("idx", sorted(IDX))
def test_gather_window_row_template_widths(h100, r, idx):
    """gather_window on the row template: 8-byte vectors at r = 10, 16-byte
    at 16 and 32, 4-byte at 3; int32 and int64 ids; exact."""
    g = torch.Generator().manual_seed(r)
    X = torch.randn((10_000, r), generator=g).cuda()
    wins = torch.randint(0, 10_000 // 128, (41,), generator=g).to(IDX[idx])
    offs = torch.randint(0, 128, (41 * 512,), generator=g).to(IDX[idx])
    got = ga.gather_window(X, wins.cuda(), offs.cuda(), 128, 512)
    torch.cuda.synchronize()
    assert torch.equal(got, ga.gather_window_plain(X, wins.cuda(),
                                                   offs.cuda(), 128, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("S,L", [(8, 128), (32, 1024), (4096, 1024),
                                 (3, 20000)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_lanes_matches_its_plain_version(h100, S, L, dtype):
    """(3, 20000) in float64 is 160 KB a row: read from global memory, not
    staged through shared memory."""
    g = torch.Generator().manual_seed(S)
    X = torch.randn((S, L), generator=g, dtype=DTYPES[dtype]).cuda()
    i = torch.randint(0, L, (S, L), generator=g,
                      dtype=torch.int32).cuda()
    before = ga.LANES.launches
    got = ga.gather_lanes(X, i)
    torch.cuda.synchronize()
    assert ga.LANES.launches == before + 1
    assert torch.equal(got, ga.gather_lanes_plain(X, i))


@pytest.mark.cuda
def test_gather_refuses_what_it_does_not_take(h100):
    X = torch.zeros((10, 4), device="cuda")
    i = torch.zeros(3, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError):
        ga.gather_rows(X.half(), i)
    with pytest.raises(TypeError):
        ga.gather_rows(X, i.float())
    with pytest.raises(ValueError):
        ga.gather_rows(X.t(), i)
    with pytest.raises(ValueError):
        ga.gather_rows(X, i.cpu())


@pytest.mark.cuda
def test_spmm_and_a_fast_diagonal_solve_run_the_gather_kernel(h100):
    """C@X through the ELL layout on the card equals the CPU's, and a
    MaxCut past n_pad 2048 runs on the fast-diagonal engine with the
    block-Lanczos bound (forced), launching gather_rows and no K1."""
    A = problems.synthetic_graph(3000, 8)
    C, As, b = problems.maxcut(A)
    cp = compile_problem(SDPProblem(C, As, np.asarray(b, float), None),
                         dense=False)
    X = np.random.default_rng(0).standard_normal((cp.n_pad, 10))
    out = {}
    for device in ("cuda", "cpu"):
        dp = to_device(cp, torch.float64, device)
        out[device] = spmm_C(dp, torch.tensor(X, device=device)).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-12,
                               atol=1e-12)
    # one gather_rows launch per SpMM, over tier 1 and tier 2 together
    dp = to_device(cp, torch.float32, "cuda")
    assert dp.has_ell2
    Xc = torch.tensor(X, dtype=torch.float32, device="cuda")
    before = ga.ROWS.launches
    for _ in range(3):
        spmm_C(dp, Xc)
    torch.cuda.synchronize()
    assert ga.ROWS.launches == before + 3
    kw = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=3000.0,
              dtype="float32", seed=0, printlevel=0, lanczos_block=16,
              dense_mode=False)
    k1, rows = mk.K1.launches, ga.ROWS.launches
    res = sdplr(C, As, b, 10, **kw)
    assert res["inner_engine"] == ENGINE_FAST
    assert ga.ROWS.launches > rows and mk.K1.launches == k1
    assert res["dual_passes"] > 0
    assert res["primal_vio"] <= 1e-2 and res["rel_duality_gap"] <= 1e-2


@pytest.mark.cuda
def test_gather_gives_nan_for_an_index_outside_x(h100):
    """An index outside X reads nothing and gives NaN; the rest agree."""
    X = torch.randn((100, 10), device="cuda")
    i = torch.tensor([0, 99, 100, -1, 2**40, 5], device="cuda")
    got = ga.gather_rows(X, i)
    bad = torch.tensor([False, False, True, True, True, False])
    assert torch.isnan(got[bad.cuda()]).all()
    assert torch.equal(got[~bad.cuda()], X[i[~bad.cuda()]])
    w = torch.tensor([0, 9], device="cuda")
    o = torch.tensor([[3, 12], [5, 10]], device="cuda")
    gw = ga.gather_window(X, w, o, 10, 2)
    assert torch.equal(gw[:3], X[torch.tensor([3, 12, 95], device="cuda")])
    assert torch.isnan(gw[3]).all()
    li = torch.zeros((2, 10), dtype=torch.int64)
    li[0, 1], li[1, 0], li[1, 1] = 10, 9, -1
    gl = ga.gather_lanes(X[:2].contiguous(), li.cuda())
    assert gl[0, 0] == X[0, 0] and gl[1, 0] == X[1, 9]
    assert torch.isnan(gl[0, 1]) and torch.isnan(gl[1, 1])
