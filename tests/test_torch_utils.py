"""The port's utilities against the JAX package's, on inputs made from a
numpy seed: the writers (byte-identical files, the SDPLR reader's round
trip), performance profiles, the graph readers, the rounding callbacks
(torch on the CPU against the JAX package's numpy loops, exactly in
float64), the compile-cache directory, the default data root, the
timing helpers and ``synthetic_local_graph``."""

import importlib.util
import os
import zipfile

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from sdplrplus_tpu.models import problems as j_models
from sdplrplus_tpu.utils import io as j_io
from sdplrplus_tpu.utils import perfprofile as j_pp
from sdplrplus_tpu.utils import rounding as j_round
from sdplrplus_tpu.utils import writers as j_wr
from sdplrplus_tpu_torch.models import (
    make_random_graph, maxcut, minimum_bisection, mu_conductance_ineq,
    synthetic_graph, synthetic_local_graph,
)
from sdplrplus_tpu_torch.utils import build, cache, timing
from sdplrplus_tpu_torch.utils import io as t_io
from sdplrplus_tpu_torch.utils import perfprofile as t_pp
from sdplrplus_tpu_torch.utils import rounding as t_round
from sdplrplus_tpu_torch.utils import writers as t_wr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_run_module():
    """The JAX package's experiment script ``exps/run.py`` as a module
    (its generators import nothing of JAX)."""
    spec = importlib.util.spec_from_file_location(
        "jax_exps_run", os.path.join(ROOT, "exps", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _instances():
    A = make_random_graph(9, 0.5, seed=3)
    return {"maxcut": maxcut(A),
            "minimum_bisection": minimum_bisection(A),
            "mu_conductance": mu_conductance_ineq(A, 0.1)[:3]}


def _jax_instance(name):
    A = make_random_graph(9, 0.5, seed=3)
    if name == "mu_conductance":
        return j_models.mu_conductance_ineq(A, 0.1)[:3]
    return getattr(j_models, name)(A)


@pytest.mark.parametrize("name", ["maxcut", "minimum_bisection",
                                  "mu_conductance"])
@pytest.mark.parametrize("fmt", ["sdplr", "sdpa"])
def test_writers_write_the_jax_packages_bytes(tmp_path, name, fmt):
    C, As, b = _instances()[name]
    if fmt == "sdpa" and name != "maxcut":
        # SDPA export takes sparse operands only, in both packages
        with pytest.raises(ValueError):
            t_wr.write_problem_sdpa(str(tmp_path / "t"), C, As, b)
        with pytest.raises(ValueError):
            j_wr.write_problem_sdpa(str(tmp_path / "j"),
                                    *_jax_instance(name))
        return
    write = f"write_problem_{fmt}"
    getattr(t_wr, write)(str(tmp_path / "t"), C, As, b)
    getattr(j_wr, write)(str(tmp_path / "j"), *_jax_instance(name))
    t, j = (tmp_path / "t").read_bytes(), (tmp_path / "j").read_bytes()
    assert t == j and len(t) > 0


def test_initial_solution_writer_writes_the_jax_packages_bytes(tmp_path):
    rng = np.random.default_rng(5)
    R, lam = rng.normal(size=(7, 3)), rng.normal(size=5)
    t_wr.write_initial_solution(str(tmp_path / "t"), R, lam)
    j_wr.write_initial_solution(str(tmp_path / "j"), R, lam)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.mark.parametrize("name", ["maxcut", "minimum_bisection",
                                  "mu_conductance"])
def test_read_problem_sdplr_round_trips(tmp_path, name):
    """Written by the port, read back by both packages' readers: the same
    operands, and the same 𝒜(RRᵀ) as the original problem."""
    C, As, b = _instances()[name]
    path = str(tmp_path / "p.sdplr")
    t_wr.write_problem_sdplr(path, C, As, b)
    C2, As2, b2 = t_wr.read_problem_sdplr(path)
    Cj, Asj, bj = j_wr.read_problem_sdplr(path)
    np.testing.assert_array_equal(b2, bj)
    np.testing.assert_array_equal(b2, b)
    R = np.random.default_rng(1).normal(size=(C.n, 3))
    X = R @ R.T
    values = lambda C_, As_: [float(np.sum(M * X))
                              for M in _dense_all(C_, As_)]
    want = values(C, As)
    np.testing.assert_allclose(values(C2, As2), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(values(Cj, Asj), want, rtol=1e-12, atol=1e-12)


def _dense_all(C, As):
    out = []
    for M in [C] + list(As):
        if hasattr(M, "B"):
            out.append(M.B @ np.diag(M.d) @ M.B.T)
        else:
            D = np.zeros((M.n, M.n))
            np.add.at(D, (M.rows, M.cols), M.vals)
            out.append(D)
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tau_max", [None, 4.0])
def test_performance_profile_equals_the_jax_packages(seed, tau_max):
    rng = np.random.default_rng(seed)
    T = rng.uniform(0.5, 10.0, size=(12, 3))
    T[rng.uniform(size=T.shape) < 0.15] = np.inf
    T[0, 1] = np.nan
    taus, rho = t_pp.performance_profile(T, tau_max=tau_max)
    jt, jr = j_pp.performance_profile(T, tau_max=tau_max)
    np.testing.assert_array_equal(taus, jt)
    np.testing.assert_array_equal(rho, jr)


def test_plot_performance_profile_writes_a_file(tmp_path):
    T = np.array([[1.0, 2.0], [2.0, 1.0], [1.0, np.inf]])
    out = t_pp.plot_performance_profile(T, ["a", "b"],
                                        str(tmp_path / "p.png"))
    assert os.path.exists(out) and os.path.getsize(out) > 0


def _edge_text(seed):
    rng = np.random.default_rng(seed)
    n, m = 30, 80
    I = rng.integers(1, n + 1, m)
    J = rng.integers(1, n + 1, m)
    W = rng.choice([1.0, -1.0, 2.0], m)
    lines = [f"{n} {m}"] + [f"{i} {j} {w:g}" for i, j, w in zip(I, J, W)]
    return "\n".join(lines) + "\n"


def _assert_same_csr(a, b):
    assert a.shape == b.shape
    assert (a != b).nnz == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_read_gset_equals_the_jax_packages(tmp_path, seed):
    path = tmp_path / "g.txt"
    path.write_text(_edge_text(seed))
    _assert_same_csr(t_io.read_gset(str(path)), j_io.read_gset(str(path)))


@pytest.mark.parametrize("base", [0, 1])
def test_read_zip_edges_equals_the_jax_packages(tmp_path, base):
    rng = np.random.default_rng(base + 7)
    rows = ["src,dst"] + [f"{i + base},{j + base}" for i, j in
                          zip(rng.integers(0, 25, 70),
                              rng.integers(0, 25, 70))]
    path = str(tmp_path / "net.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("net/net_edges.csv", "\n".join(rows) + "\n")
    got = t_io.read_zip_edges(path)
    _assert_same_csr(got, j_io.read_zip_edges(path))
    assert got.nnz > 0


def test_read_edge_list_equals_the_jax_packages(tmp_path):
    path = tmp_path / "e.txt"
    path.write_text("# comment\n0 1\n1 2\n2 0\n3 1\n")
    _assert_same_csr(t_io.read_edge_list(str(path)),
                     j_io.read_edge_list(str(path)))


@pytest.mark.parametrize("largest", [False, True])
def test_postprocess_graph_and_pad_to_even_equal_the_jax_packages(largest):
    rng = np.random.default_rng(11)
    M = sp.random(21, 21, density=0.1, random_state=rng, format="csr")
    M.setdiag(1.0)
    _assert_same_csr(t_io.postprocess_graph(M, largest_component=largest),
                     j_io.postprocess_graph(M, largest_component=largest))
    for A in (M, M[:20, :20]):
        _assert_same_csr(t_io.pad_to_even(A), j_io.pad_to_even(A))
    assert t_io.pad_to_even(M).shape == (22, 22)


def test_load_mat_adjacency_and_gset_path_equal_the_jax_packages(tmp_path):
    A = synthetic_graph(40, 4)
    os.makedirs(tmp_path / "MaxCut")
    path = t_io.gset_path("G0", root=str(tmp_path))
    assert path == j_io.gset_path("G0", root=str(tmp_path))
    scipy.io.savemat(path, {"A": A})
    got = t_io.load_mat_adjacency(path)
    _assert_same_csr(got, j_io.load_mat_adjacency(path))
    _assert_same_csr(got, A)


def test_default_data_root_lies_inside_the_checkout():
    root = os.path.realpath(t_io.DATA_ROOT)
    assert root == os.path.join(os.path.realpath(ROOT), "exps", "data")
    assert t_io.gset_path("G1").startswith(root + os.sep)


def _rounding_case(seed, n=50, r=6):
    rng = np.random.default_rng(seed)
    A = make_random_graph(n, 0.8, seed=seed)
    R = rng.normal(size=(n, r))
    return A, R


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_cuts", [1, 37])
def test_maxcut_rounding_equals_the_jax_packages(seed, n_cuts):
    A, R = _rounding_case(seed)
    got = t_round.maxcut_rounding(A, R, n_cuts=n_cuts, seed=seed,
                                  device="cpu")
    assert got == j_round.maxcut_rounding(A, R, n_cuts=n_cuts, seed=seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_cuts", [1, 37])
def test_minimum_bisection_rounding_equals_the_jax_packages(seed, n_cuts):
    A, R = _rounding_case(seed, n=51)   # odd n: ⌊n/2⌋ vertices get +1
    got = t_round.minimum_bisection_rounding(A, R, n_cuts=n_cuts,
                                             seed=seed, device="cpu")
    assert got == j_round.minimum_bisection_rounding(A, R, n_cuts=n_cuts,
                                                     seed=seed)


def test_rounding_helpers_and_device_default(monkeypatch):
    import torch

    A, R = _rounding_case(0, n=10)
    L = t_round._laplacian(A)
    _assert_same_csr(L, j_round._laplacian(A))
    x = np.sign(np.random.default_rng(0).normal(size=10))
    assert t_round.eval_cut(L, x) == j_round.eval_cut(L, x)
    assert t_round.dummy_callback(A, R) == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_round.maxcut_rounding(A, R)


def test_enable_compile_cache_sets_and_returns_the_build_dir(
        tmp_path, monkeypatch):
    monkeypatch.delenv(build.BUILD_ENV, raising=False)
    default = cache.enable_compile_cache()
    assert default == build.build_dir()
    assert build.BUILD_ENV not in os.environ
    target = str(tmp_path / "nvcc_cache")
    assert cache.enable_compile_cache(target) == target
    assert os.environ[build.BUILD_ENV] == target
    assert build.build_dir() == target and os.path.isdir(target)
    assert cache.enable_compile_cache(target) == target   # idempotent
    assert cache.enable_compile_cache() == target
    monkeypatch.delenv(build.BUILD_ENV)
    assert build.build_dir() == default


@pytest.mark.parametrize("nbytes,flops,dtype,want", [
    (3.35e12, 1.0, "float32", (1.0, "bytes")),
    (1.0, 67e12, "float32", (1.0, "operations")),
    (1.0, 34e12, "float64", (1.0, "operations")),
    (6.7e12, 67e12, "float32", (2.0, "bytes")),
])
def test_bound_is_the_larger_of_bytes_and_operations(nbytes, flops, dtype,
                                                      want):
    got = timing.bound_s(nbytes, flops, dtype)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)


def test_timer_reads_the_host_clock_on_the_cpu():
    import time

    t = timing.Timer("cpu")
    t.start()
    time.sleep(0.01)
    assert 0.01 <= t.stop() < 5.0


@pytest.mark.parametrize("n,deg,window,seed", [(50, 3, 12, 1),
                                               (200, 5, 20, 4)])
def test_synthetic_local_graph_equals_the_jax_scripts(n, deg, window, seed):
    ref = _jax_run_module().synthetic_local_graph(n, deg, window, seed=seed)
    _assert_same_csr(synthetic_local_graph(n, deg, window, seed=seed), ref)
