"""The CUDA kernels on the card: K1, K2 and the three gather kernels
against their plain versions, and solves served by them. Every test here
needs an H100 and nvcc (marker ``cuda``) and skips elsewhere. The file imports no JAX, so it runs on a machine
that has only PyTorch (``--noconftest``: tests/conftest.py sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import collections

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


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["minimum_bisection", "maxcut"])
def test_k1_within_rounding_of_the_extended_evaluation(h100, family):
    """K1 on the card and its plain version on the CPU, in float64 at
    r = 64, k = 16, steps 0..5, each against the same loop evaluated in
    longdouble on the host (ops/megakernel_ext.py): every entry of G
    within a few units (8) of its float64 rounding scale, R and the
    violations to 1e-9. At MinBisection's step 2 the two float64 values
    differ by up to 3.3e-9 in G (|G| ≈ 120) and each lies about that far
    from the extended one: the coupling 1ᵀX1 builds G from terms five
    decades larger that cancel, and both orders of summation round."""
    from sdplrplus_tpu_torch.ops import megakernel_ext as mx

    for steps in range(6):
        spec, args, _, _ = mx.k1_case("cuda", family, steps)
        ext = mx.mega_chunk_ext(spec, *args)
        before = mk.K1.launches
        out = mk.mega_kernel(spec, *args)
        torch.cuda.synchronize()
        assert mk.K1.launches == before + 1
        spec_c, args_c, _, _ = mx.k1_case("cpu", family, steps)
        for rep in (mx.rounding_report(ext, out),
                    mx.rounding_report(ext, mk.mega_chunk_plain(spec_c,
                                                                *args_c))):
            assert rep["dG_in_scale_units"] <= 8.0, (steps, rep)
            assert rep["max_dR"] <= 1e-9 and rep["max_dvio"] <= 1e-9, rep


@pytest.mark.cuda
def test_theta_solve_on_the_card_matches_the_cpu(h100):
    """A small Lovász-θ solve (C₇₂², θ = 24, trace-rescaled) on the
    entry-mask engine on the card and on the CPU, float64: both meet the
    tolerances, the objectives agree to 1e-3 and the card's carries ran
    their row gathers through gather_rows, with no K1 or K2 launch."""
    from sdplrplus_tpu_torch.solver.outer import ENGINE_ENTRY

    C, As, b = problems.lovasz_theta(problems.synthetic_cycle_power(72, 2))
    kw = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=1.0,
              dtype="float64", seed=0, printlevel=0, maxtime=120.0)
    k1, k2, rows = mk.K1.launches, mk.K2.launches, ga.ROWS.launches
    res = sdplr(C, As, b, 4, **kw)
    assert res["inner_engine"] == ENGINE_ENTRY
    assert mk.K1.launches == k1 and mk.K2.launches == k2
    assert ga.ROWS.launches > rows
    ref = sdplr(C, As, b, 4, device="cpu", **kw)
    for r in (res, ref):
        assert r["primal_vio"] <= 1e-2 and r["rel_duality_gap"] <= 1e-2
        assert r["entry_rescale_f"] == 72.0
    assert abs(res["obj"] - ref["obj"]) <= 1e-3 * abs(ref["obj"])


@pytest.mark.cuda
def test_entry_step_graph_matches_the_eager_step(h100):
    """The entry-mode inner step replayed as a CUDA graph against the same
    step run eagerly, on the card in float64 (θ of a 60-node random graph,
    r = 6, k = 4): 25 steps with no early exit, then a second chunk through
    the same captured graph with new multipliers and σ, then a chunk that
    stops on its gradient tolerance. R, G, the violations, L, the ring and
    its Grams agree to 1e-10 (relative to each one's largest entry), and
    the step counts and ring heads are equal."""
    from sdplrplus_tpu_torch.solver import inner_entry
    from sdplrplus_tpu_torch.solver.al import al_value_grad

    A = problems.make_random_graph(60, 0.5, seed=2)
    C, As, b = problems.lovasz_theta(A)
    dp = to_device(compile_problem(SDPProblem(C, As, np.asarray(b, float),
                                              None)), torch.float64, "cuda")
    assert dp.ew_c2 is not None
    rng = np.random.default_rng(0)
    t = lambda x: torch.tensor(x, dtype=torch.float64, device="cuda")
    r, k = 6, 4
    R0 = np.zeros((dp.n_pad, r))
    R0[:60] = rng.uniform(-1, 1, (60, r)) / np.sqrt(60 * r)
    R = t(R0)

    graphs = inner_entry.EntryGraphs()

    def both(lam, sigma, gtol, steps):
        L, vio, G, _, gn, _ = al_value_grad(dp, R, lam, sigma, True, True)
        out = []
        for graph in (True, False):
            out.append(inner_entry.entry_chunk(
                dp, R, G, vio, L, gn, lbfgs_init(k, dp.n_pad, r,
                                                 torch.float64, "cuda"),
                lam, sigma, gtol, float("-inf"), steps, k=k,
                gtol_relative=True, ptol_relative=True, graph=graph,
                graphs=graphs))
        (cg, vg), (ce, ve) = out
        assert cg.steps == ce.steps and cg.lbfgs.head == ce.lbfgs.head
        for a, e in ((cg.R, ce.R), (cg.G, ce.G), (cg.vio_raw, ce.vio_raw),
                     (cg.L_val, ce.L_val), (cg.lbfgs.s_hist, ce.lbfgs.s_hist),
                     (cg.lbfgs.y_hist, ce.lbfgs.y_hist),
                     (cg.lbfgs.sty, ce.lbfgs.sty), (vg, ve)):
            assert float((a - e).abs().max()) <= 1e-10 * float(
                e.abs().max().clamp(min=1e-300)), (a, e)
        return cg

    c1 = both(t(np.zeros(dp.m)), t(10.0), -1.0, 25)
    assert c1.steps == 25
    graph1 = graphs._g
    c2 = both(t(0.1 * rng.standard_normal(dp.m)), t(40.0), -1.0, 25)
    assert graphs._g is graph1 and c2.steps == 25
    # the first chunk's path again, stopping where its gradient first falls
    # to 1.0001 × the norm it ended at
    c3 = both(t(np.zeros(dp.m)), t(10.0), 1.0001 * float(c1.grad_norm), 500)
    assert 0 < c3.steps <= 25


# ---- the general engine (slice E) and the host-driven loop ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("idx", sorted(IDX))
@pytest.mark.parametrize("w", [2 * r for r in (1, 10, 20, 40, 80, 160, 320,
                                                425)] + [2 * 97, 3, 97])
def test_gather_rows_at_the_general_paths_widths(h100, dtype, idx, w):
    """gather_rows at the widths of the general engine's [R|D] gather: 2r
    for every rank of the doubling schedule from r₀ = 10 to the
    Barvinok–Pataki cap of C₁₀₀₀₀⁹'s m = 90,001 (425), and r = 1; odd
    widths (2·97 = 194 makes 8-byte but not 16-byte rows in float32; 3 and
    97 4-byte ones); int32 and int64 ids; exactly equal to X[idx]."""
    g = torch.Generator().manual_seed(w)
    X = torch.randn((3000, w), generator=g, dtype=DTYPES[dtype]).cuda()
    i = torch.randint(0, 3000, (4099,), generator=g).to(IDX[idx]).cuda()
    before = ga.ROWS.launches
    got = ga.gather_rows(X, i)
    torch.cuda.synchronize()
    assert ga.ROWS.launches == before + 1
    assert torch.equal(got, X[i.long()])


def _general_theta(device, n=300):
    A = problems.synthetic_cycle_power(n, 3)
    C, As, b = problems.lovasz_theta(A)
    cp = compile_problem(SDPProblem(C, As, np.asarray(b, float), None),
                         entry=False)
    return to_device(cp, torch.float64, device)


@pytest.mark.cuda
def test_general_operators_on_the_card_match_the_cpu(h100):
    """The general A_linesearch ([R|D] through gather_rows) and apply_S
    (the ELL SpMM through gather_rows) on the card against the CPU, in
    float64, to 1e-12 of each result's largest entry; two gather_rows
    launches."""
    from sdplrplus_tpu_torch.ops import adjoint, forward

    dps = {d: _general_theta(d) for d in ("cuda", "cpu")}
    assert forward.is_general(dps["cpu"])
    rng = np.random.default_rng(4)
    n_pad, m = dps["cpu"].n_pad, dps["cpu"].m
    R, D = rng.normal(size=(2, n_pad, 7))
    y = rng.normal(size=m + 1)
    out = {}
    for d, dp in dps.items():
        t = lambda x: torch.tensor(x, dtype=torch.float64, device=d)
        before = ga.ROWS.launches
        out[d] = forward.A_linesearch(dp, t(R), t(D)) + (
            adjoint.apply_S(dp, t(y), t(R)),)
        if d == "cuda":
            torch.cuda.synchronize()
            assert ga.ROWS.launches == before + 2
    for a, b_ in zip(out["cuda"], out["cpu"]):
        a = a.cpu().numpy()
        b_ = b_.numpy()
        assert np.max(np.abs(a - b_)) <= 1e-12 * np.max(np.abs(b_))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["maxcut", "lovasz_theta"])
def test_host_driver_matches_the_fused_driver_on_the_card(h100, family):
    """fused_outer=False against the fused driver on the card, float64
    (tests/test_e2e.py:130): MaxCut on K1 and θ with entry_mode=False on
    the general engine take the same iterations and major iterations and
    agree in the objective to 1e-8."""
    from sdplrplus_tpu_torch.solver.outer import ENGINE_GENERAL

    theta = family == "lovasz_theta"
    # the general path converges θ only on small graphs (ROADMAP F6)
    A = problems.make_random_graph(10, 0.5, seed=7) if theta \
        else problems.make_random_graph(60, 0.3, seed=7)
    C, As, b = getattr(problems, family)(A)
    kw = dict(ptol=1e-3, objtol=1e-3, prior_trace_bound=1.0 if theta
              else 60.0, dtype="float64", seed=0, printlevel=0,
              maxmajoriter=100)
    if theta:
        kw["entry_mode"] = False
    k1 = mk.K1.launches
    rf = sdplr(C, As, b, 4, **kw)
    rh = sdplr(C, As, b, 4, fused_outer=False, **kw)
    want = ENGINE_GENERAL if theta else ENGINE_KERNEL
    assert rf["inner_engine"] == rh["inner_engine"] == want
    assert (mk.K1.launches > k1) == (not theta)
    assert rf["iter"] == rh["iter"] and rf["majoriter"] == rh["majoriter"]
    assert abs(rf["obj"] - rh["obj"]) <= 1e-8 * max(1.0, abs(rh["obj"]))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rounding_on_the_card_equals_the_cpu(h100, seed):
    """Both roundings on the card and on the CPU from the same R and
    hyperplanes: the same best cut (integer sums, exact in float64)."""
    from sdplrplus_tpu_torch.utils.rounding import (
        maxcut_rounding, minimum_bisection_rounding,
    )

    A = problems.make_random_graph(301, 0.7, seed=seed)
    R = np.random.default_rng(seed).normal(size=(301, 10))
    for fn in (maxcut_rounding, minimum_bisection_rounding):
        assert fn(A, R, seed=seed) == fn(A, R, seed=seed, device="cpu")


@pytest.mark.cuda
def test_cli_on_the_card_writes_a_cuda_artifact(h100, tmp_path):
    """The experiment CLI at n = 200 on the card (the default device):
    K1 serves MaxCut, and the artifact names the card and its power
    limit."""
    import json

    from sdplrplus_tpu_torch.exps import run

    before = mk.K1.launches
    res = run.main(["--problem", "MaxCut", "--synthetic-n", "200", "--deg",
                    "8", "--graph", "SYN200", "--output", str(tmp_path)])
    assert mk.K1.launches > before
    assert res["inner_engine"] == ENGINE_KERNEL
    with open(res["artifact"]) as f:
        short = json.load(f)
    assert short["backend"] == "cuda"
    assert short["device"] == torch.cuda.get_device_name(0)
    assert short["power_limit"].endswith("W")
    assert short["primal_vio"] <= 1e-2 and short["rel_duality_gap"] <= 1e-2
    assert (tmp_path / "MaxCut" / "SYN200"
            / "SDPLRTORCH-R-10-seed-0-tol-0.01_state.npz").exists()


@pytest.mark.cuda
def test_bench_micro_reads_each_operators_device_time(h100):
    """The per-operator timer on the card at n = 300: every row has the
    kernels' device time from torch.profiler beside the host-issue time,
    and its share of the bound is taken against the device time."""
    from sdplrplus_tpu_torch.exps import bench_micro

    rows = bench_micro.main(["--synthetic-n", "300", "--deg", "8",
                             "--iters", "20"])
    assert [r["op"] for r in rows][-1] == "lbfgs_direction"
    for r in rows:
        assert r["device_us"] > 0 and r["kernels_per_call"] >= 1
        assert r["issue_us"] > 0
        assert r["share_of_bound"] == r["bound_us"] / r["device_us"]
        assert r["device"] == torch.cuda.get_device_name(0)


# ---- the sharded solve on the card (parallel/) ------------------------------

@pytest.mark.cuda
def test_cuda_one_rank_nccl_solve(h100):
    """solve(..., mesh=make_mesh(1, backend="nccl")) on the card: the
    sharded program at world size 1 on the fast-diagonal engine (named
    +spmd, one gather_rows launch per ELL SpMM) reaches the unsharded
    objective to the solve's objtol (1e-3 relative, float64; the tier-2
    index_add sums in a varying order on the card, so the trajectories
    need not be equal), both certified to 1e-3."""
    import torch.distributed as dist

    from sdplrplus_tpu_torch import SolverConfig
    from sdplrplus_tpu_torch.ops import spmm as spmm_mod
    from sdplrplus_tpu_torch.parallel.spmd import make_mesh
    from sdplrplus_tpu_torch.solver import inner
    from sdplrplus_tpu_torch.solver.outer import solve

    A = problems.synthetic_graph(3000, 8)
    C, As, b = problems.maxcut(A)
    prob = SDPProblem(C, As, np.asarray(b, float), None)
    cfg = SolverConfig(ptol=1e-3, objtol=1e-3, prior_trace_bound=3000.0,
                       dtype="float64", printlevel=0, dense_mode=False)
    ref = solve(prob, 8, cfg)
    mesh = make_mesh(1, backend="nccl")
    try:
        before = ga.ROWS.launches, spmm_mod.CALLS["spmm_ell"]
        inner.STATS.clear()
        res = solve(prob, 8, cfg, mesh=mesh)
        launches = ga.ROWS.launches - before[0]
        spmms = spmm_mod.CALLS["spmm_ell"] - before[1]
    finally:
        dist.destroy_process_group()
    assert ref["inner_engine"] == ENGINE_FAST
    assert res["inner_engine"] == ENGINE_FAST + "+spmd"
    assert res["devices"] == 1
    assert abs(res["obj"] - ref["obj"]) <= 1e-3 * abs(ref["obj"])
    for r_ in (ref, res):
        assert r_["primal_vio"] <= 1e-3 and r_["rel_duality_gap"] <= 1e-3
    # the inner loop ran through the captured chunk, NCCL calls inside
    assert inner.STATS["replays"] == inner.STATS["chunks"] > 0
    assert launches == spmms > 0


@pytest.mark.cuda
def test_cuda_two_rank_gloo_steps_equal_one_rank(h100, tmp_path):
    """Two ranks sharing the card over gloo (collectives staged through
    host memory): 25 fast-diagonal steps with the halo exchange equal the
    one-rank run on the card (R to 1e-9, L and grad_norm to 1e-9
    relative), each rank launching gather_rows once per SpMM: one for the
    carried CX, then one per step run, the 25 taken in eager chunks of K
    masked steps (a gloo mesh is not captured)."""
    import math

    import torch_spmd_cases as cases

    from sdplrplus_tpu_torch.solver.inner import CHUNK_K

    got = cases.launch_ranks(str(tmp_path), 2, ["halo_inner"],
                             device="cuda")["halo_inner"]
    prob, cp = cases.halo_setup(2, dense=False)
    dp = to_device(cp, torch.float64, "cuda")
    R0 = cases.halo_R0(cp)
    lam = torch.zeros(prob.m, dtype=torch.float64, device="cuda")
    L, vio, G, y, gn, _ = cases.fg_state(dp, R0, lam, 2.0)
    from sdplrplus_tpu_torch.solver.inner import inner_chunk

    c, _ = inner_chunk(dp, torch.tensor(R0, device="cuda"), G, y, vio, L,
                       gn, lbfgs_init(4, cp.n_pad, 4, torch.float64, "cuda"),
                       lam, 2.0, 0.0, -math.inf, 25, k=4, use_armijo=False,
                       gtol_relative=True, ptol_relative=True)
    assert got["halo"] and got["steps"] == c.steps == 25
    assert got["gather_rows"] == 1 + CHUNK_K * math.ceil(25 / CHUNK_K)
    np.testing.assert_allclose(np.asarray(got["R"]), c.R.cpu().numpy(),
                               rtol=0, atol=1e-9)
    for key, w in (("L", float(c.L_val)), ("grad_norm", float(c.grad_norm))):
        assert abs(got[key] - w) <= 1e-9 * max(1.0, abs(w))


@pytest.mark.cuda
def test_cuda_devices_beyond_the_cards_raise(h100):
    """devices above the machine's card count raises, naming the count;
    nothing drops to the CPU or to one rank."""
    have = torch.cuda.device_count()
    C, As, b = problems.maxcut(problems.make_random_graph(20, 0.5, seed=1))
    with pytest.raises(ValueError, match=f"this machine has {have}"):
        sdplr(C, As, b, 2, devices=have + 1, printlevel=0)


@pytest.mark.cuda
def test_cuda_one_rank_nccl_entry_step_graph(h100):
    """θ of C₇₂² (= 24) on the entry-mask engine at one NCCL rank: the
    entry step, collectives included, is captured as a CUDA graph (NCCL
    calls are capturable; a gloo mesh runs the eager step) and the solve
    reaches θ within 1e-2 as the unsharded one does."""
    import torch.distributed as dist

    from sdplrplus_tpu_torch import SolverConfig
    from sdplrplus_tpu_torch.parallel.spmd import make_mesh
    from sdplrplus_tpu_torch.solver import inner_entry
    from sdplrplus_tpu_torch.solver.outer import solve

    C, As, b = problems.lovasz_theta(problems.synthetic_cycle_power(72, 2))
    prob = SDPProblem(C, As, np.asarray(b, float), None)
    cfg = SolverConfig(ptol=1e-2, objtol=1e-2, prior_trace_bound=1.0,
                       dtype="float32", printlevel=0)
    captured = []
    real = inner_entry._EntryGraph.__init__

    def counted(self, *a, **k):
        captured.append(1)
        return real(self, *a, **k)

    mesh = make_mesh(1, backend="nccl")
    try:
        inner_entry._EntryGraph.__init__ = counted
        res = solve(prob, 10, cfg, mesh=mesh)
    finally:
        inner_entry._EntryGraph.__init__ = real
        dist.destroy_process_group()
    assert res["inner_engine"] == "entry-mask-torch+spmd"
    assert captured, "the entry step was not captured"
    assert abs(-res["obj"] - 24.0) <= 24.0 * 1e-2
    assert res["primal_vio"] <= 1e-2


def _chunk_case(engine, dtype=torch.float64, device="cuda"):
    """(dp, R, λ, use_armijo) on ``device``: MaxCut of a 200-node graph
    with C dense or sparse (the fast-diagonal engine, ELL with tier-2
    rows), μ-conductance (0.1) of the same graph at the feasible scale
    (Armijo), or θ of a 40-node graph outside entry mode (general)."""
    A = problems.make_random_graph(200, 0.5, seed=3)
    rng = np.random.default_rng(0)
    if engine == "general":
        A = problems.make_random_graph(40, 0.4, seed=3)
        C, As, b = problems.lovasz_theta(A)
        cp = compile_problem(SDPProblem(C, As, np.asarray(b, float), None),
                             entry=False, dense=False)
    elif engine == "fast-diag-armijo":
        C, As, b, ct = problems.mu_conductance_ineq(A, 0.1)
        cp = compile_problem(SDPProblem(C, As, np.asarray(b, float), ct))
    else:
        C, As, b = problems.maxcut(A)
        cp = compile_problem(SDPProblem(C, As, np.asarray(b, float), None),
                             dense=engine == "dense")
    dp = to_device(cp, dtype, device)
    n, r = A.shape[0], 6
    Rn = rng.uniform(-1, 1, (n, r))
    if engine == "fast-diag-armijo":    # d-centred, ⟨D, X⟩ = 1
        d = np.asarray(A.sum(axis=1)).reshape(-1)
        Rn -= np.outer(np.ones(n), d @ Rn / d.sum())
        Rn /= np.sqrt(np.sum(d * np.sum(Rn * Rn, axis=1)))
    R = np.zeros((dp.n_pad, r))
    R[:n] = Rn
    lam = np.minimum(0.05 * rng.standard_normal(dp.m),
                     dp.lam_ub.cpu().numpy())
    t = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return dp, t(R), t(lam), engine == "fast-diag-armijo"


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "fast-diag", "fast-diag-armijo",
                                    "general"])
def test_inner_chunk_graph_matches_the_eager_program(h100, engine):
    """The inner loop's chunk program captured as a CUDA graph against the
    same masked program run eagerly (twice), in float64: 25 steps (K does
    not divide 25), then through the same graph with new multipliers and
    a gradient tolerance that trips inside a replay (at a step whose norm
    is a new minimum by 1e-3). Steps, the stagnation flag and the ring
    head equal; R, G, the violations, L and the ring bit-equal on the
    dense engine, elsewhere within a tolerance of each one's largest
    entry (or ten times the two eager runs' difference, where larger):
    the ELL SpMM's tier-2 index_add adds with atomics, whose order varies
    from run to run, graph and eager alike, and each AL's stiffness
    amplifies that over 25 steps: 1e-10 on MaxCut, 1e-9 on μ-conductance
    (1.8e-11 measured on the card), 1e-12 on θ (bit-equal measured)."""
    from sdplrplus_tpu_torch.solver import inner
    from sdplrplus_tpu_torch.solver.al import al_value_grad

    dp, R, lam, arm = _chunk_case(engine)
    graphs = inner.InnerGraphs()
    t = lambda x: torch.tensor(x, dtype=torch.float64, device="cuda")
    tol = {"fast-diag": 1e-10, "fast-diag-armijo": 1e-9}.get(engine, 1e-12)

    def rel(a, b):
        fields = lambda c: (c.R, c.G, c.vio_raw, c.L_val, c.lbfgs.s_hist,
                            c.lbfgs.y_hist, c.lbfgs.rho, c.lbfgs.sty,
                            c.lbfgs.yty)
        return max(float((x - y).abs().max())
                   / max(float(y.abs().max()), 1e-300)
                   for x, y in zip(fields(a), fields(b)))

    def both(lam, gtol, steps=25):
        L, vio, G, y, gn, _ = al_value_grad(dp, R, lam, t(2.0), True, True)
        out = []
        for graph in (True, False, False):
            inner.STATS.clear()
            c, _ = inner.inner_chunk(
                dp, R, G, y, vio, L, gn,
                lbfgs_init(4, dp.n_pad, R.shape[1], torch.float64, "cuda"),
                lam, t(2.0), gtol, float("-inf"), steps, k=4,
                use_armijo=arm, gtol_relative=True, ptol_relative=True,
                graph=graph, graphs=graphs)
            out.append((c, collections.Counter(inner.STATS)))
        (cg, sg), (ce, se), (ce2, _) = out
        assert sg["replays"] == se["chunks"] > 0 and se["replays"] == 0
        for c in (ce, ce2):
            assert (cg.steps, cg.stagnated, cg.lbfgs.head) == \
                (c.steps, c.stagnated, c.lbfgs.head)
        if engine == "dense":
            assert rel(cg, ce) == 0.0 and rel(ce2, ce) == 0.0
        else:
            assert min(rel(cg, ce), rel(cg, ce2)) <= max(
                tol, 10.0 * rel(ce2, ce))
        return cg, sg

    c1, s1 = both(lam, -1.0)
    assert c1.steps == 25 and s1["captures"] == 1
    # the eager norms of steps 1..20 at the new multipliers; the tolerance
    # just above the last new minimum (by 1e-3) at a step K does not divide
    lam2 = 0.5 * lam
    L, vio, G, y, gn, _ = al_value_grad(dp, R, lam2, t(2.0), True, True)
    ic = inner.InnerCarry(
        R=R, G=G, y_full=y, vio_raw=vio, L_val=L, grad_norm=gn,
        lbfgs=lbfgs_init(4, dp.n_pad, R.shape[1], torch.float64, "cuda"),
        steps=0, stagnated=False,
        CX=spmm_C(dp, R) if engine.startswith("fast-diag") else None)
    norms = [float(gn)]
    for _ in range(20):
        ic = inner.inner_step(dp, ic, lam2, t(2.0), float("-inf"), k=4,
                              use_armijo=arm, gtol_relative=True,
                              use_cx=ic.CX is not None)
        norms.append(float(ic.grad_norm))
    trip = [s for s in range(1, 21) if s % inner.CHUNK_K
            and norms[s] * (1 + 1e-3) < min(norms[:s])][-1]
    c2, s2 = both(lam2, norms[trip] * (1 + 1e-6))
    assert s2["captures"] == 0 and c2.steps == trip


@pytest.mark.cuda
def test_inner_graphs_in_one_pool_match_the_eager_program(h100):
    """Captures into the kept pool, one after the other, on the dense
    engine in float64: 25 steps at rank 6, then at rank 3 through the
    same ``InnerGraphs`` (a new key: the first graph released, a second
    capture), then a capture at rank 6 by another ``InnerGraphs``, which
    releases the rank-3 graph, so the first captures again when it runs
    next. Every capture goes into the pool and frees no device memory,
    and every graph's carry equals the eager program's bit for bit."""
    from sdplrplus_tpu_torch.solver import inner
    from sdplrplus_tpu_torch.solver.al import al_value_grad

    dp, R6, lam, _ = _chunk_case("dense")
    t = lambda x: torch.tensor(x, dtype=torch.float64, device="cuda")
    fields = lambda c: (c.R, c.G, c.y_full, c.vio_raw, c.L_val,
                        c.grad_norm, c.lbfgs.s_hist, c.lbfgs.y_hist,
                        c.lbfgs.rho, c.lbfgs.sty, c.lbfgs.yty)

    def run(R, graph, graphs=None):
        L, vio, G, y, gn, _ = al_value_grad(dp, R, lam, t(2.0), True, True)
        c, _ = inner.inner_chunk(
            dp, R, G, y, vio, L, gn,
            lbfgs_init(4, dp.n_pad, R.shape[1], torch.float64, "cuda"),
            lam, t(2.0), -1.0, float("-inf"), 25, k=4, use_armijo=False,
            gtol_relative=True, ptol_relative=True, graph=graph,
            graphs=graphs)
        return c

    def graph_equals_eager(R, graphs, captures):
        before = collections.Counter(inner.STATS)
        cg = run(R, True, graphs)
        d = collections.Counter(inner.STATS)
        d.subtract(before)
        assert d["captures"] == d["pooled_captures"] == captures
        assert d["capture_frees"] == 0
        ce = run(R, False)
        assert cg.steps == ce.steps == 25
        assert cg.lbfgs.head == ce.lbfgs.head
        for x, y in zip(fields(cg), fields(ce)):
            assert torch.equal(x, y)

    R3 = R6[:, :3].contiguous()
    graphs, other = inner.InnerGraphs(), inner.InnerGraphs()
    graph_equals_eager(R6, graphs, 1)      # builds the pool
    graph_equals_eager(R3, graphs, 1)      # a new key: the second capture
    graph_equals_eager(R3, graphs, 0)      # the same graph, replayed
    graph_equals_eager(R6, other, 1)       # releases graphs' rank-3 graph
    graph_equals_eager(R3, graphs, 1)      # so it captures again


@pytest.mark.cuda
def test_launch_counters_count_every_replay(h100):
    """gather_rows launches and ELL SpMMs under replay: each replay adds
    what one capture launched (K steps, one SpMM each, on the
    fast-diagonal engine), the capture itself adds nothing and its warm-up
    steps are real launches. Through the graph and eagerly both counters
    equal 1 (the carried CX) + the steps run on the device."""
    from sdplrplus_tpu_torch.ops import spmm as spmm_mod
    from sdplrplus_tpu_torch.solver import inner
    from sdplrplus_tpu_torch.solver.al import al_value_grad

    dp, R, lam, _ = _chunk_case("fast-diag")
    t = lambda x: torch.tensor(x, dtype=torch.float64, device="cuda")
    L, vio, G, y, gn, _ = al_value_grad(dp, R, lam, t(2.0), True, True)
    K = inner.CHUNK_K
    for graph in (True, False):
        inner.STATS.clear()
        rows, spmms = ga.ROWS.launches, spmm_mod.CALLS["spmm_ell"]
        c, _ = inner.inner_chunk(
            dp, R, G, y, vio, L, gn,
            lbfgs_init(4, dp.n_pad, R.shape[1], torch.float64, "cuda"), lam,
            t(2.0), -1.0, float("-inf"), 13, k=4, use_armijo=False,
            gtol_relative=True, ptol_relative=True, graph=graph)
        st = inner.STATS
        assert c.steps == 13 and st["chunks"] == -(-13 // K)
        run = st["steps"] + st["masked"] + st["warmup_steps"]
        assert st["warmup_steps"] == (inner.WARMUP_STEPS if graph else 0)
        assert ga.ROWS.launches - rows == 1 + run
        assert spmm_mod.CALLS["spmm_ell"] - spmms == 1 + run


@pytest.mark.cuda
def test_spans_of_fast_diagonal_solves_on_the_card(h100, tmp_path):
    """Two fast-diagonal solves under the profiler: an
    ``sdplr.inner.capture`` in each solve (each solve captures its own
    inner chunk, one per rank it runs at; the second solve's one capture
    goes into the kept pool and frees no device memory), and device
    kernels whose
    launching runtime call lies inside an ``sdplr.inner`` span, matched
    by the trace's correlation ids (a replay's kernels go to its
    cudaGraphLaunch)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from sdplrplus_tpu_torch.solver import inner

    A = problems.synthetic_graph(3000, 8)
    C, As, b = problems.maxcut(A)
    kw = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=3000.0,
              dtype="float32", seed=0, printlevel=0, dense_mode=False)
    sdplr(C, As, b, 10, **kw)             # builds and loads the kernels
    inner.STATS.clear()
    res, per_solve = [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in (1, 2):
            before = collections.Counter(inner.STATS)
            res.append(sdplr(C, As, b, 10, **dict(kw, seed=s)))
            per_solve.append(collections.Counter(inner.STATS))
            per_solve[-1].subtract(before)
        torch.cuda.synchronize()
    assert all(r["inner_engine"] == ENGINE_FAST for r in res)
    # the second solve captures into the pool the first one used, and
    # its captures return no memory to the driver
    second = per_solve[1]
    assert second["captures"] == second["pooled_captures"] == 1
    assert second["capture_frees"] == 0
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and str(e["name"]).startswith("sdplr.")]
    count = collections.Counter(e["name"] for e in ann)
    assert count["sdplr.solve"] == 2
    assert count["sdplr.inner.capture"] == inner.STATS["captures"]
    solves = [(e["ts"], e["ts"] + e["dur"]) for e in ann
              if e["name"] == "sdplr.solve"]
    for s, t in solves:
        assert any(s <= e["ts"] <= t for e in ann
                   if e["name"] == "sdplr.inner.capture")
    tid = next(e["tid"] for e in ann if e["name"] == "sdplr.solve")
    inner_spans = [(e["ts"], e["ts"] + e["dur"]) for e in ann
                   if e["name"] == "sdplr.inner" and e["tid"] == tid]
    assert inner_spans
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") == "cuda_runtime" and e["tid"] == tid
            and "correlation" in e.get("args", {})
            and any(s <= e["ts"] <= t for s, t in inner_spans)}
    under = [e for e in events if e.get("cat") == "kernel"
             and e.get("args", {}).get("correlation") in corr]
    assert under
    assert any("gather_rows" in e["name"] for e in under)
