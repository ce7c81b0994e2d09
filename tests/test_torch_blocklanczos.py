"""The port's block-Lanczos dual bound against the JAX package's.

Each function of sdplrplus_tpu_torch/ops/blocklanczos.py is held against
its counterpart in sdplrplus_tpu/ops/blocklanczos.py on the same numpy
inputs (the start block's random numbers are drawn from the JAX key and
handed to the port): float64 to 1e-10 for the pieces, θ, margin and the
step count for the whole recurrence, which must also be a valid and tight
estimate of λ_min against a dense float64 ``eigvalsh``. The path selection
(``_want_block_lanczos``, ``_blk_for``) matches the JAX package's on the
cases of tests/test_blocklanczos.py, and an end-to-end solve with the
block bound forced matches ``sdplrplus_tpu.sdplr`` without over-certifying
against float64.

One difference is by design and tested as such: on a partial breakdown
(some lanes of a block converged, others not) the JAX package ends the
recurrence and certifies the Ritz value nearest the converged lanes; the
port deflates and goes on (ops/blocklanczos.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sdplrplus_tpu import sdplr as j_sdplr
from sdplrplus_tpu.compile import compile_problem as j_compile
from sdplrplus_tpu.models.problems import maxcut as j_maxcut
from sdplrplus_tpu.ops import blocklanczos as jbl
from sdplrplus_tpu.ops.adjoint import assemble_s_tri
from sdplrplus_tpu.ops.device import to_device as j_to_device
from sdplrplus_tpu.problem import SDPProblem as JProblem
from sdplrplus_tpu.solver.outer import _want_block_lanczos as j_want
from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.compile import compile_problem
from sdplrplus_tpu_torch.models import maxcut, synthetic_graph
from sdplrplus_tpu_torch.ops import blocklanczos as bl
from sdplrplus_tpu_torch.ops.device import to_device
from sdplrplus_tpu_torch.problem import SDPProblem
from sdplrplus_tpu_torch.solver.dualbound import dual_obj
from sdplrplus_tpu_torch.solver.outer import _blk_for, _want_block_lanczos

DT = {"float32": (torch.float32, jnp.float32),
      "float64": (torch.float64, jnp.float64)}


def _problems(A, dtype):
    tdt, jdt = DT[dtype]
    C, As, b = maxcut(A)
    tdp = to_device(compile_problem(SDPProblem(C, As, np.asarray(b, float),
                                               None)), tdt, "cpu")
    jC, jAs, jb = j_maxcut(A)[:3]
    jdp = j_to_device(j_compile(JProblem(jC, list(jAs),
                                         np.asarray(jb, float), None)), jdt)
    return tdp, jdp, C


def _dense_S(C, y_head, n):
    S = np.zeros((n, n))
    S[C.rows, C.cols] += C.vals
    S[np.arange(n), np.arange(n)] += y_head
    return S


def _draws(key, n_pad, b, r, jdt):
    """The start block's random numbers as the JAX package draws them."""
    k1, k2 = jax.random.split(key)
    V_full = np.asarray(jax.random.normal(k2, (n_pad, b), dtype=jdt))
    G = np.asarray(jax.random.normal(k1, (r, min(r, max(b - 4, 1))),
                                     dtype=jdt))
    return V_full, G


@pytest.mark.parametrize("n", [240, 2048, 20000, 100_000])
@pytest.mark.parametrize("r", [1, 10, 20, 24, 64])
@pytest.mark.parametrize("block", [0, 8, 16])
def test_block_sizes_match_the_jax_package(n, r, block):
    assert bl.block_sizes(n, r, block) == jbl.block_sizes(n, r, block)


def test_seed_block_matches_the_jax_package():
    A = synthetic_graph(240, 8, 11)
    tdp, jdp, _ = _problems(A, "float64")
    rng = np.random.default_rng(0)
    R = rng.standard_normal((tdp.n_pad, 10))
    key = jax.random.PRNGKey(4)
    want = np.asarray(jbl._seed_block(jdp, key, jnp.asarray(R), 16,
                                      jnp.float64))
    got = bl._seed_block(tdp, None, torch.tensor(R), 16, torch.float64,
                         _draws(key, tdp.n_pad, 16, 10, jnp.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", ["random", "deficient", "vanished"])
def test_cholqr_matches_the_jax_package(kind):
    A = synthetic_graph(240, 8, 11)
    tdp, jdp, _ = _problems(A, "float64")
    rng = np.random.default_rng(1)
    W = rng.standard_normal((tdp.n_pad, 8)) * np.logspace(0, -2, 8)
    if kind == "deficient":
        W[:, 3] = W[:, 0] + W[:, 1]
    if kind == "vanished":
        W *= 1e-300
    Qj, Bj, fj = jbl._cholqr(jdp, jnp.asarray(W), jnp.asarray(2.0))
    Qt, Bt, ft = bl._cholqr(torch.tensor(W), 2.0)
    assert bool(ft) == bool(fj) == (kind != "random")
    # a dependent block's trailing pivots are the jitter's √(4·eps), so
    # the entries behind them carry rounding amplified ~10⁷-fold: held to
    # 1e-9 of the largest entry there
    Bmax = float(np.max(np.abs(np.asarray(Bj))))
    np.testing.assert_allclose(
        Bt.numpy(), np.asarray(Bj), rtol=1e-10,
        atol=1e-9 * Bmax if kind == "deficient" else 1e-10)
    if kind == "random":
        np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(Qt.T @ Qt, np.eye(8), atol=1e-10)
        np.testing.assert_allclose((Qt @ Bt).numpy(), W, atol=1e-10)


@pytest.mark.parametrize("k_eff", [0, 1, 3, 6])
def test_block_tridiag_certified_matches_the_jax_package(k_eff):
    rng = np.random.default_rng(k_eff)
    k_max, b = 6, 4
    A = rng.standard_normal((k_max, b, b))
    A = 0.5 * (A + A.transpose(0, 2, 1))
    B = np.triu(rng.standard_normal((k_max, b, b)))
    th_j, mg_j, ok_j = jbl.block_tridiag_min_eig_certified(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(k_eff))
    th, mg, ok = bl.block_tridiag_min_eig_certified(torch.tensor(A),
                                                     torch.tensor(B), k_eff)
    assert ok == bool(ok_j) == (k_eff > 0)
    np.testing.assert_allclose(th, float(th_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(mg, float(mg_j), rtol=1e-10, atol=1e-10)


def _bl_case(dtype, b, k_max):
    """tests/test_blocklanczos.py's n = 240 MaxCut with a random multiplier
    and a random factor seed, in both packages."""
    n = 240
    A = synthetic_graph(n, 8, 11)
    tdp, jdp, C = _problems(A, dtype)
    rng = np.random.default_rng(0)
    lam = rng.normal(size=jdp.m) * 0.1
    y_head = -np.minimum(np.asarray(jdp.lam_ub), lam)
    y_np = np.concatenate([y_head, [1.0]])
    R = rng.normal(size=(jdp.n_pad, 10))
    lam_min = float(np.linalg.eigvalsh(_dense_S(C, y_head, n))[0])
    return tdp, jdp, y_np, R, lam_min


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("b,k_max", [(8, 24), (16, 16)])
def test_block_lanczos_matches_the_jax_package(dtype, b, k_max):
    tdt, jdt = DT[dtype]
    tdp, jdp, y_np, R, lam_min = _bl_case(dtype, b, k_max)
    y_full = jnp.asarray(y_np, jdt)
    key = jax.random.PRNGKey(1)
    th_j, mg_j, k_j = jbl.block_lanczos_min_eig(
        jdp, assemble_s_tri(jdp, y_full), y_full, key,
        jnp.asarray(R, jdt), jnp.asarray(1e-5, jdt),
        jnp.asarray(8, jnp.int32), b=b, k_max=k_max)
    th, mg, k_used = bl.block_lanczos_min_eig(
        tdp, torch.tensor(y_np, dtype=tdt), None, torch.tensor(R, dtype=tdt),
        1e-5, 8, b=b, k_max=k_max,
        seed_draws=_draws(key, tdp.n_pad, b, 10, jdt))
    assert k_used == int(k_j)
    if dtype == "float64":
        np.testing.assert_allclose(th, float(th_j), rtol=1e-10)
        np.testing.assert_allclose(mg, float(mg_j), rtol=1e-6)
    else:
        # float32 recurrences in two summation orders
        np.testing.assert_allclose(th, float(th_j), rtol=1e-5)
        np.testing.assert_allclose(mg, float(mg_j), rtol=1e-3)
    cert = th - mg
    assert cert <= lam_min + 5e-4 * max(abs(lam_min), 1.0)
    assert abs(cert - lam_min) <= 1e-2 * max(abs(lam_min), 1.0)
    assert 1 <= k_used <= k_max


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_partial_breakdown_deflates_instead_of_over_certifying(dtype):
    """Ten isolated vertices with y = 0 make an exact eigenspace of S at
    eigenvalue 0 while λ_min ≈ −1.62. A factor seed spanning it makes the
    first block's residual lanes vanish: the JAX package stops after one
    step and certifies ≈ 0; the port deflates, goes on, and certifies
    λ_min."""
    tdt, jdt = DT[dtype]
    n, n_iso, b, k_max = 240, 10, 16, 12
    A = sp.block_diag([synthetic_graph(n - n_iso, 8, 11),
                       sp.csr_matrix((n_iso, n_iso))]).tocsr()
    tdp, jdp, C = _problems(A, dtype)
    y_head = np.r_[np.full(n - n_iso, 5.0), np.zeros(n_iso)]
    y_np = np.concatenate([y_head, [1.0]])
    lam_min = float(np.linalg.eigvalsh(_dense_S(C, y_head, n))[0])
    R = np.zeros((jdp.n_pad, n_iso))
    R[n - n_iso:n] = np.eye(n_iso)
    key = jax.random.PRNGKey(1)
    y_full = jnp.asarray(y_np, jdt)
    th_j, mg_j, k_j = jbl.block_lanczos_min_eig(
        jdp, assemble_s_tri(jdp, y_full), y_full, key, jnp.asarray(R, jdt),
        jnp.asarray(1e-5, jdt), jnp.asarray(8, jnp.int32), b=b, k_max=k_max)
    assert int(k_j) == 1
    assert float(th_j) - float(mg_j) > lam_min + 1.0   # over-certifies
    th, mg, k_used = bl.block_lanczos_min_eig(
        tdp, torch.tensor(y_np, dtype=tdt), torch.Generator().manual_seed(3),
        torch.tensor(R, dtype=tdt), 1e-5, 8, b=b, k_max=k_max,
        seed_draws=_draws(key, tdp.n_pad, b, n_iso, jdt))
    assert k_used > 1
    cert = th - mg
    assert cert <= lam_min + 5e-4 * abs(lam_min)
    assert abs(cert - lam_min) <= 1e-2 * abs(lam_min)


def test_path_selection_matches_the_jax_package():
    """The cases of tests/test_blocklanczos.py: block when forced, past
    n = 4096, or when the scalar schedule wants more than 1024 steps at
    1024 < n (the mid-solve escalation at n = 2048)."""
    cases = [(0, False, 2048, 800), (0, False, 2048, 1500),
             (0, False, 800, 4000), (0, False, 8192, 100),
             (-1, False, 2048, 1500), (0, True, 8192, 1500),
             (16, False, 800, 10), (0, False, 20000, 0)]
    for lb, hp, n, q in cases:
        assert _want_block_lanczos(lb, hp, n, q) == j_want(lb, hp, n, q)
        blk = _blk_for(lb, hp, n, 20, q)
        want = jbl.block_sizes(n, 20, max(lb, 0)) if j_want(lb, hp, n, q) \
            else (0, 0)
        assert blk == want
    b, k_max = _blk_for(0, False, 2048, 20, 1500)
    assert b >= 8 and k_max >= 4 and b * k_max <= 512
    assert _blk_for(0, False, 20000, 10) == (16, 32)


def test_dual_obj_block_path_is_a_valid_bound():
    """dual_obj(block=...) at the least-squares multiplier of a random
    factor: a valid and tight bound against float64 eigvalsh at the
    multiplier it returns."""
    n = 240
    A = synthetic_graph(n, 8, 11)
    tdp, _, C = _problems(A, "float64")
    rng = np.random.default_rng(5)
    R = torch.tensor(rng.standard_normal((tdp.n_pad, 10)))
    R[n:] = 0
    lam = torch.tensor(rng.normal(size=tdp.m) * 0.1)
    vio = torch.zeros(tdp.m + 1, dtype=torch.float64)
    dv, min_eig, y_full = dual_obj(
        tdp, lam, torch.tensor(1.0, dtype=torch.float64), vio, float(n), 100,
        torch.Generator().manual_seed(0), R=R, block=(16, 12),
        margin_target=1e-6, k_min=8)
    y_head = y_full[:n].numpy()
    lam_min = float(np.linalg.eigvalsh(_dense_S(C, y_head, n))[0])
    truth = float(-y_head @ np.ones(n)) + n * min(lam_min, 0.0)
    assert min_eig <= lam_min + 1e-8
    assert dv <= truth + 1e-6 * abs(truth)
    assert dv >= truth - 1e-3 * abs(truth)


def test_e2e_block_matches_the_jax_package():
    """tests/test_blocklanczos.py's n = 600 solve with the block bound
    forced: the objectives agree, the certificate holds in float64 at the
    solver's multiplier, and the bound ran block passes."""
    n = 600
    A = synthetic_graph(n, 10, 3)
    kw = dict(prior_trace_bound=float(n), ptol=1e-2, objtol=1e-2,
              printlevel=0, dtype="float32", lanczos_block=16, seed=0)
    C, As, b = maxcut(A)
    res = sdplr(C, As, b, 8, device="cpu", **kw)
    ref = j_sdplr(*j_maxcut(A)[:3], 8, **kw)
    assert abs(res["obj"] - ref["obj"]) <= 1e-2 * abs(ref["obj"])
    assert res["primal_vio"] <= 1e-2 and res["rel_duality_gap"] <= 1e-2
    y_head = -np.asarray(res["lambda"], np.float64)
    lam_min = float(np.linalg.eigvalsh(_dense_S(C, y_head, n))[0])
    dual_f64 = float(-y_head @ b) + n * min(lam_min, 0.0)
    obj_f = res["obj_feasible"] if res["obj_feasible"] is not None \
        else res["obj"]
    gap_f64 = (obj_f - dual_f64) / min(abs(obj_f), abs(dual_f64))
    assert res["rel_duality_gap"] >= gap_f64 - 2e-3
    assert res["max_dual_value"] <= dual_f64 + 1e-3 * abs(dual_f64)
    assert res["dual_passes"] > 0


# sdplrplus_tpu.sdplr on the CPU, float32, seed 0, on the same instance
# and arguments as below (chip_smoke.py records the same run). That run
# stops early on an over-certified bound (ROADMAP F5), so the solve is
# also held to the JAX package's committed SYN20K result
# (exps/output/MaxCut/SYN20K/SDPLRTPU-R-10-seed-0-tol-0.01.json).
JAX_SYN20K_OBJ = -213944.546875
JAX_SYN20K_ARTIFACT_OBJ = -214563.25


@pytest.mark.slow
def test_syn20k_on_the_cpu():
    """SYN20K, the JAX package's scale instance (n = 20,000, 319,699
    edges): the fast-diagonal engine with the block bound, within 1e-2 of
    the JAX package's objective, and not over-certified against float64
    eigsh at the solver's multiplier. About two minutes on a CPU."""
    from scipy.sparse.linalg import eigsh

    n = 20000
    A = synthetic_graph(n, 16)
    C, As, b = maxcut(A)
    res = sdplr(C, As, b, 10, prior_trace_bound=float(n), ptol=1e-2,
                objtol=1e-2, dtype="float32", seed=0, printlevel=0,
                device="cpu")
    assert res["inner_engine"] == "fast-diag-torch"
    assert res["dual_passes"] > 0
    assert res["primal_vio"] <= 1e-2 and res["rel_duality_gap"] <= 1e-2
    assert abs(res["obj"] - JAX_SYN20K_OBJ) <= 1e-2 * abs(JAX_SYN20K_OBJ)
    assert abs(res["obj"] - JAX_SYN20K_ARTIFACT_OBJ) \
        <= 1e-2 * abs(JAX_SYN20K_ARTIFACT_OBJ)
    y = -np.asarray(res["lambda"], np.float64)
    S = sp.csr_matrix((C.vals, (C.rows, C.cols)), shape=(n, n)) \
        + sp.diags(y)
    lam_min = float(eigsh(S, k=1, which="SA", tol=1e-7)[0][0])
    dual_f64 = float(-y @ b) + n * min(lam_min, 0.0)
    obj_f = res["obj_feasible"]
    gap_f64 = (obj_f - dual_f64) / min(abs(obj_f), abs(dual_f64))
    assert res["rel_duality_gap"] >= gap_f64 - 2e-3
