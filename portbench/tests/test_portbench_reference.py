"""The float64 reference, its TF32 control and the frozen graph
generators, on the CPU."""

import numpy as np
import pytest
import scipy.sparse as sp

from portbench.families import gnp, torus
from portbench.reference import maxcut, tf32


def test_single_edge_is_exact():
    # K2: optimum -1 at X = [[1, -1], [-1, 1]], dual λ = (-1/2, -1/2)
    inst = maxcut.formulation(sp.csr_matrix(np.array([[0., 1.], [1., 0.]])))
    assert inst.trace_bound == 2.0
    got = maxcut.certify(inst, np.array([[1.0], [-1.0]]),
                         np.array([-0.5, -0.5]))
    assert got["pinfeas"] == 0.0
    assert got["obj"] == pytest.approx(-1.0, abs=1e-15)
    assert got["bound"] == pytest.approx(-1.0, abs=1e-12)
    assert got["gap"] == pytest.approx(0.0, abs=1e-12)


def test_readings_against_dense_arithmetic(monkeypatch):
    rng = np.random.default_rng(3)
    A = gnp.graph({"n": 40, "density_pct": 20}, 5)
    inst = maxcut.formulation(A)
    C = inst.C
    np.testing.assert_array_equal(inst.b, np.ones(40))
    L = np.diag(A.sum(axis=1).A1) - A.toarray()
    np.testing.assert_allclose(C.toarray(), -0.25 * L)
    R = rng.standard_normal((40, 3))
    lam = rng.standard_normal(40)
    Rh = R / np.linalg.norm(R, axis=1)[:, None]
    got = maxcut.certify(inst, R, lam)
    assert got["pinfeas"] == pytest.approx(
        np.linalg.norm((R * R).sum(1) - 1) / np.sqrt(40), rel=1e-12)
    assert got["obj"] == pytest.approx(np.trace(C.toarray() @ Rh @ Rh.T),
                                       rel=1e-12)
    lmin = np.linalg.eigvalsh(C.toarray() - np.diag(lam))[0]
    assert got["bound"] == pytest.approx(lam.sum() + 40 * min(lmin, 0),
                                         rel=1e-12)
    # the sparse eigensolver, used above DENSE_EIG_MAX_N, agrees
    monkeypatch.setattr(maxcut, "DENSE_EIG_MAX_N", 10)
    assert maxcut.certify(inst, R, lam)["bound"] == pytest.approx(
        got["bound"], rel=1e-9)


@pytest.mark.parametrize("ritz_off", [0.0, 0.37])
def test_sparse_min_eig_brackets_the_least_eigenvalue(monkeypatch, ritz_off):
    # a torus S with its bottom eigenvalues clustered, as at a solution
    A = torus.graph({"h": 12, "w": 25}, 4)
    C = maxcut.formulation(A).C
    lam = np.linalg.eigvalsh(C.toarray())[0] + np.linspace(0, 1e-3, 300)
    S = (C - sp.diags(lam)).tocsr()
    exact = np.linalg.eigvalsh(S.toarray())[0]
    monkeypatch.setattr(maxcut, "DENSE_EIG_MAX_N", 10)
    real = maxcut.spla.eigsh
    # a Ritz value that has not converged lies above λ_min, never below
    monkeypatch.setattr(maxcut.spla, "eigsh",
                        lambda *a, **k: real(*a, **k) + ritz_off)
    lo = maxcut.min_eig(S)
    # the factorization decides positive definiteness to rounding, ~1e-15
    assert lo - 1e-12 <= exact <= lo + maxcut.EIG_TOL


def test_tf32_rounding():
    x = np.array([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-10 + 2**-12,
                  -3.14159, 0.0], np.float32)
    assert tf32.tf32(x).tolist() == [1.0, 1.0, 1 + 2**-9, 1 + 2**-10,
                                     -3.140625, 0.0]
    y = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    rel = np.abs(tf32.tf32(y) - y) / np.abs(y)
    assert rel.max() <= 2**-11 and rel.max() > 2**-13


def test_tf32_control_departs_from_float64():
    A = torus.graph({"h": 10, "w": 30}, 2)
    inst = maxcut.formulation(A)
    rng = np.random.default_rng(1)
    R = rng.standard_normal((300, 4))
    R /= np.linalg.norm(R, axis=1)[:, None]
    R *= 1 + 0.003 * rng.standard_normal((300, 1))
    lam = -np.asarray(abs(A).sum(axis=1)).ravel() / 2
    ref = maxcut.certify(inst, R, lam)
    ctl = maxcut.certify_tf32(inst, R, lam)
    assert abs(ctl["obj"] - ref["obj"]) / abs(ref["obj"]) > 1e-7
    assert abs(ctl["pinfeas"] - ref["pinfeas"]) > 1e-6


@pytest.mark.parametrize("seed", [1, 2, 12345678901])
def test_torus_has_g81s_shape(seed):
    A = torus.graph({"h": 100, "w": 200}, seed)
    assert A.shape == (20000, 20000) and A.nnz == 2 * 40000
    assert (A != A.T).nnz == 0 and A.diagonal().sum() == 0
    assert set(np.unique(A.data)) == {-1.0, 1.0}
    assert (np.asarray(abs(A).sum(axis=1)).ravel() == 4).all()
    # vertex (i, j) = 200 i + j: right and lower neighbours, wrapping
    assert A[0, 1] != 0 and A[0, 199] != 0 and A[0, 200] != 0
    assert A[0, 19800] != 0 and A[0, 201] == 0
    assert abs((A.data > 0).mean() - 0.5) < 0.01
    assert (torus.graph({"h": 100, "w": 200}, seed) != A).nnz == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 12345678901])
def test_gnp_has_g1s_edge_count(seed):
    # rudy -rnd_graph 800 6: exactly round(6 * 800 * 799 / 200) = 19,176
    assert gnp.edges(800, 6) == 19176
    A = gnp.graph({"n": 800, "density_pct": 6}, seed)
    assert (A != A.T).nnz == 0 and A.diagonal().sum() == 0
    assert set(np.unique(A.data)) == {1.0}
    assert A.nnz == 2 * 19176
    assert (gnp.graph({"n": 800, "density_pct": 6}, seed) != A).nnz == 0


def test_gnp_has_the_gset_counts():
    # G22 (-rnd_graph 2000 1), G43 (1000 2), G55 (5000 0.1), G60 (7000 0.07)
    assert [gnp.edges(2000, 1), gnp.edges(1000, 2), gnp.edges(5000, 0.1),
            gnp.edges(7000, 0.07)] == [19990, 9990, 12498, 17148]
