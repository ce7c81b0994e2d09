"""The port's host-driven loop (``fused_outer=False``), checkpoints,
``solve_model`` with the external-model adapter, and ``profile_dir``.

The host loop is held against the port's fused driver as
tests/test_e2e.py:130/157/209 hold the JAX package's two drivers: the
same iterations, major iterations and bounds, the trajectory to 1e-7 and
the objective to 1e-8 (relative); and one host solve against the JAX
package's host loop on the same input and seed (iterations equal,
objective to 1e-6). Checkpoints are held to tests/test_utils.py:70-106
in both directions between the packages; ``solve_model`` to obj = −1
(tests/test_units.py:155, which the JAX package itself fails, ROADMAP
F1); the adapter's products to the compiled problem's to 1e-10.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sdplrplus_tpu import sdplr as j_sdplr
from sdplrplus_tpu.models import problems as j_models
from sdplrplus_tpu.utils import checkpoint as j_ckpt

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.adapter import dense_model, make_custom_model
from sdplrplus_tpu_torch.compile import compile_problem
from sdplrplus_tpu_torch.models import problems as t_models
from sdplrplus_tpu_torch.ops import adjoint as t_adjoint
from sdplrplus_tpu_torch.ops import forward as t_forward
from sdplrplus_tpu_torch.ops.device import to_device
from sdplrplus_tpu_torch.problem import SDPProblem
from sdplrplus_tpu_torch.solver.outer import (
    ENGINE_ENTRY, ENGINE_FAST, ENGINE_GENERAL, ENGINE_PLAIN, ENGINE_TORCH,
    solve_model,
)
from sdplrplus_tpu_torch.utils import checkpoint as t_ckpt

F64 = torch.float64
K2 = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 0.0]]))
CPU = dict(device="cpu", printlevel=0, dtype="float64")


def _both(gen_args, r, **kw):
    rf = sdplr(*gen_args, r, fused_outer=True, **kw)
    rh = sdplr(*gen_args, r, fused_outer=False, **kw)
    return rf, rh


# ------------------------------------------------- fused against host driver

@pytest.mark.parametrize("impl,engine", [("xla", ENGINE_TORCH),
                                         ("mega", ENGINE_PLAIN)])
def test_fused_matches_host_driver(impl, engine):
    """tests/test_e2e.py:130 on both inner engines of the dense MaxCut
    (the torch loop and K1's plain version): the same iterates, major
    schedule and dual bookkeeping."""
    A = j_models.make_random_graph(20, 0.5, seed=7)
    rf, rh = _both(t_models.maxcut(A), 4, objtol=1e-3, ptol=1e-3,
                   prior_trace_bound=20.0, maxmajoriter=100,
                   inner_impl=impl, **CPU)
    assert rf["inner_engine"] == rh["inner_engine"] == engine
    assert rf["iter"] == rh["iter"]
    assert rf["majoriter"] == rh["majoriter"]
    assert abs(rf["obj"] - rh["obj"]) < 1e-8 * max(1.0, abs(rh["obj"]))
    np.testing.assert_allclose(rf["R"], rh["R"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(rf["lambda"], rh["lambda"], rtol=1e-6,
                               atol=1e-8)
    assert abs(rf["max_dual_value"] - rh["max_dual_value"]) < 1e-3 * max(
        1.0, abs(rh["max_dual_value"]))
    assert set(rf) <= set(rh)


@pytest.mark.parametrize("impl,engine", [("xla", ENGINE_TORCH),
                                         ("mega", ENGINE_PLAIN)])
def test_fused_matches_host_driver_inequality(impl, engine):
    """tests/test_e2e.py:157 through the Armijo path, on the torch loop
    and on K2's plain version."""
    C, As, b, ct = t_models.relaxed_maxcut_ineq(K2)
    rf, rh = _both((C, As, b), 1, constraint_types=ct, fprec=0.0,
                   objtol=1e-5, ptol=1e-6, prior_trace_bound=2.0,
                   maxmajoriter=200, inner_impl=impl, **CPU)
    assert rf["inner_engine"] == rh["inner_engine"] == engine
    assert rf["iter"] == rh["iter"]
    assert rf["majoriter"] == rh["majoriter"]
    assert abs(rf["obj"] - rh["obj"]) < 1e-8


@pytest.mark.parametrize("entry,engine", [(False, ENGINE_GENERAL),
                                          (None, ENGINE_ENTRY)])
def test_fused_matches_host_driver_theta(entry, engine):
    """Lovász θ on the general engine and on the entry-mask engine: the
    two drivers take the same iterations, major iterations and bounds."""
    A = j_models.make_random_graph(10, 0.5, seed=7)
    rf, rh = _both(t_models.lovasz_theta(A), 3, entry_mode=entry,
                   ptol=1e-3, objtol=1e-3, prior_trace_bound=1.0,
                   maxmajoriter=200, **CPU)
    assert rf["inner_engine"] == rh["inner_engine"] == engine
    assert rf["iter"] == rh["iter"]
    assert rf["majoriter"] == rh["majoriter"]
    assert rf["dual_bounds_computed"] == rh["dual_bounds_computed"]
    assert abs(rf["obj"] - rh["obj"]) < 1e-8 * max(1.0, abs(rh["obj"]))


def test_fused_matches_host_driver_n2000():
    """tests/test_e2e.py:209: n = 2000 on the fast-diagonal engine."""
    rng = np.random.default_rng(11)
    n, deg = 2000, 8
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, n * deg)
    keep = rows != cols
    A = sp.csr_matrix((np.ones(keep.sum()), (rows[keep], cols[keep])),
                      shape=(n, n))
    A = A.maximum(A.T)
    rf, rh = _both(t_models.maxcut(A), 10, objtol=1e-2, ptol=1e-2,
                   prior_trace_bound=float(n), maxmajoriter=60,
                   maxiter=4000, dense_mode=False, **CPU)
    assert rf["inner_engine"] == rh["inner_engine"] == ENGINE_FAST
    assert rf["iter"] == rh["iter"]
    assert rf["majoriter"] == rh["majoriter"]
    assert rf["dual_bounds_computed"] == rh["dual_bounds_computed"]
    assert abs(rf["obj"] - rh["obj"]) < 1e-6 * max(1.0, abs(rh["obj"]))


def test_host_driver_matches_the_jax_host_driver():
    """One host-driven solve against the JAX package's ``_solve_host`` on
    the same input, seed and dtype (float64)."""
    A = j_models.make_random_graph(20, 0.5, seed=7)
    kw = dict(objtol=1e-3, ptol=1e-3, prior_trace_bound=20.0, printlevel=0,
              maxmajoriter=100, dtype="float64", fused_outer=False,
              inner_impl="xla")
    ref = j_sdplr(*j_models.maxcut(A), 4, **kw)
    res = sdplr(*t_models.maxcut(A), 4, device="cpu", **kw)
    assert res["iter"] == ref["iter"]
    assert res["majoriter"] == ref["majoriter"]
    assert abs(res["obj"] - ref["obj"]) < 1e-6 * abs(ref["obj"])
    assert set(ref) <= set(res)


# --------------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    R = np.random.default_rng(0).normal(size=(6, 2))
    t_ckpt.save_checkpoint(path, R=R, lam=np.ones(4), sigma=4.0, r=2,
                           majoriter=3, total_iter=17)
    st = t_ckpt.load_checkpoint(path)
    assert np.allclose(st["R"], R)
    assert st["sigma"] == 4.0 and st["r"] == 2 and st["total_iter"] == 17


def test_warm_start_resume():
    """Solve, then resume from the result: the warm solve stays feasible
    and takes no more iterations (tests/test_utils.py:80)."""
    A = j_models.make_random_graph(12, 0.5, seed=4)
    C, As, b = t_models.maxcut(A)
    kw = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=12.0, **CPU)
    res = sdplr(C, As, b, 3, **kw)
    init_func, init_args, r, sigma0 = t_ckpt.warm_start_from(res)
    res2 = sdplr(C, As, b, r, init_func=init_func, init_args=init_args,
                 sigma0=sigma0, **kw)
    assert res2["primal_vio"] <= 1e-2
    assert res2["iter"] <= max(res["iter"], 10)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_solver_writes_checkpoints(tmp_path, fused):
    """tests/test_utils.py:97, through either driver."""
    path = str(tmp_path / "solver_ckpt.npz")
    A = j_models.make_random_graph(10, 0.5, seed=5)
    res = sdplr(*t_models.maxcut(A), 3, ptol=1e-3, objtol=1e-3,
                prior_trace_bound=10.0, checkpoint_path=path,
                maxmajoriter=50, fused_outer=fused, **CPU)
    st = t_ckpt.load_checkpoint(path)
    assert st["R"].shape == (10, st["r"])
    assert 0 < st["majoriter"] <= res["majoriter"]
    assert 0 < st["total_iter"] <= res["iter"]


def _resume_kw():
    return dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=12.0,
                printlevel=0, dtype="float64")


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint written by sdplrplus_tpu's solver warm-starts the
    port, which then takes no more iterations than the first solve."""
    path = str(tmp_path / "jax.npz")
    A = j_models.make_random_graph(12, 0.5, seed=4)
    first = j_sdplr(*j_models.maxcut(A), 3, checkpoint_path=path,
                    **_resume_kw())
    init_func, init_args, r, sigma0 = t_ckpt.warm_start_from(
        t_ckpt.load_checkpoint(path))
    res = sdplr(*t_models.maxcut(A), r, init_func=init_func,
                init_args=init_args, sigma0=sigma0, device="cpu",
                **_resume_kw())
    assert res["primal_vio"] <= 1e-2
    assert res["iter"] <= max(first["iter"], 10)


def test_a_port_checkpoint_resumes_in_the_jax_package(tmp_path):
    path = str(tmp_path / "port.npz")
    A = j_models.make_random_graph(12, 0.5, seed=4)
    first = sdplr(*t_models.maxcut(A), 3, checkpoint_path=path,
                  device="cpu", **_resume_kw())
    init_func, init_args, r, sigma0 = j_ckpt.warm_start_from(
        j_ckpt.load_checkpoint(path))
    res = j_sdplr(*j_models.maxcut(A), r, init_func=init_func,
                  init_args=init_args, sigma0=sigma0, **_resume_kw())
    assert res["primal_vio"] <= 1e-2
    assert res["iter"] <= max(first["iter"], 10)


# ------------------------------------------------- solve_model and adapter

def _k2_dense():
    A = K2.toarray()
    C = -0.25 * (np.diag(A.sum(axis=1)) - A)
    return C, [np.outer(e, e) for e in np.eye(2)], np.ones(2)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_solve_model_on_a_dense_model(fused):
    """tests/test_units.py:155 held to obj = −1 (the JAX package's own
    solve_model fails there, ROADMAP F1), through either driver."""
    model = dense_model(*_k2_dense(), dtype=F64, device="cpu")
    res = solve_model(model, 1, fprec=0.0, gtol=1e-8, objtol=1e-8,
                      ptol=1e-8, prior_trace_bound=2.0, printlevel=0,
                      fused_outer=fused)
    assert abs(res["obj"] - (-1.0)) < 1e-6
    assert res["inner_engine"] == ENGINE_GENERAL
    assert res["preprocess_time"] == 0.0


def test_adapter_products_equal_the_compiled_problem():
    """On θ of a random n = 9 graph, a dense_model of the same C and Aᵢ
    gives the compiled general engine's 𝒜(UUᵀ), 𝒜((UVᵀ+VUᵀ)/2), line
    search products, S·X and gradient, to 1e-10; the constraint types
    set λ_ub and the violation floor."""
    A = j_models.make_random_graph(9, 0.5, seed=2)
    C, As, b = t_models.lovasz_theta(A)
    dp = to_device(compile_problem(SDPProblem(C, As, np.asarray(b), None),
                                   entry=False), F64, "cpu")
    model = dense_model(C.todense(), [A_.todense() for A_ in As], b,
                        dtype=F64, device="cpu")
    assert model.n_pad == dp.n == 9
    rng = np.random.default_rng(3)
    U, V = (torch.tensor(rng.normal(size=(9, 3)), dtype=F64)
            for _ in range(2))
    Up, Vp = (torch.cat([X, torch.zeros(dp.n_pad - 9, 3, dtype=F64)])
              for X in (U, V))
    close = lambda a, b_: np.testing.assert_allclose(
        a.numpy(), b_.numpy(), rtol=1e-10, atol=1e-12)
    close(t_forward.A_uu(model, U), t_forward.A_uu(dp, Up))
    close(t_forward.A_uv(model, U, V), t_forward.A_uv(dp, Up, Vp))
    for got, want in zip(t_forward.A_linesearch(model, U, V),
                         t_forward.A_linesearch(dp, Up, Vp)):
        close(got, want)
    y = torch.tensor(rng.normal(size=dp.m + 1), dtype=F64)
    close(t_adjoint.apply_S(model, y, U), t_adjoint.apply_S(dp, y, Up)[:9])
    lam = torch.tensor(rng.normal(size=dp.m), dtype=F64)
    vio = t_forward.A_uu(dp, Up)
    vio = torch.cat([vio[:dp.m] - dp.b, vio[dp.m:]])
    close(t_adjoint.gradient(model, U, lam, 2.0, vio)[0],
          t_adjoint.gradient(dp, Up, lam, 2.0, vio)[0][:9])
    ct = np.r_[np.ones(dp.m - 1, bool), False]
    m2 = make_custom_model(n=9, b=b, fn_A_uu=None, fn_A_uv=None,
                           fn_apply_S=None, constraint_types=ct,
                           dtype=F64, device="cpu")
    assert m2.has_inequalities and float(m2.lam_ub[0]) == 0.0
    assert float(m2.vio_lb[-1]) == -np.inf


# ----------------------------------------------------------------- profiling

def test_profile_dir_writes_a_trace(tmp_path):
    """profile_dir records the solve with torch.profiler and writes a
    Chrome trace into the directory (outer.py:422-425's counterpart)."""
    d = str(tmp_path / "prof")
    res = sdplr(*t_models.maxcut(K2), 1, prior_trace_bound=2.0,
                profile_dir=d, **CPU)
    assert os.path.dirname(res["profile_trace"]) == d
    assert os.listdir(d) == [os.path.basename(res["profile_trace"])]
    assert os.path.getsize(res["profile_trace"]) > 0
