"""The port's slice end to end on the CPU, against the JAX package.

K₂ MaxCut, K₂ MinBisection and CutNorm on the 2×2 all-ones matrix reach
their analytic optima at the tolerances of tests/test_e2e.py; a seeded
n = 40 MaxCut lands within 1e-3 of the JAX package's objective on the
same input and seed, through both inner engines (the torch loop and K1's
plain version), as do seeded CutNorm and MinBisection solves, and the
result carries every key the JAX package reports.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from sdplrplus_tpu import sdplr as j_sdplr
from sdplrplus_tpu.models import make_random_graph
from sdplrplus_tpu.models import maxcut as j_maxcut
from sdplrplus_tpu.models import problems as j_models

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.models import cutnorm, maxcut, minimum_bisection
from sdplrplus_tpu_torch.models import problems as t_models
from sdplrplus_tpu_torch.solver.outer import (
    ENGINE_PLAIN, ENGINE_TORCH,
)

K2 = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 0.0]]))
TIGHT = dict(fprec=0.0, gtol=1e-8, objtol=1e-8, ptol=1e-8,
             prior_trace_bound=2.0, printlevel=0, device="cpu",
             dtype="float64")


def _init_func(prob, r, scale):
    rng = np.random.default_rng(42)
    return rng.normal(size=(prob.n, r)) * np.sqrt(scale), np.zeros(prob.m)


@pytest.mark.parametrize("extra", [
    {}, {"sigma0": 10.0}, {"init_func": _init_func, "init_args": (10.0,)},
    {"inner_impl": "mega"},
])
def test_maxcut_k2(extra):
    C, As, b = maxcut(K2)
    res = sdplr(C, As, b, 1, **TIGHT, **extra)
    assert abs(res["obj"] - (-1.0)) < 1e-8
    assert res["inner_engine"] == (
        ENGINE_PLAIN if extra.get("inner_impl") == "mega" else ENGINE_TORCH)


def test_minimum_bisection_k2():
    C, As, b = minimum_bisection(K2)
    res = sdplr(C, As, b, 1, **{**TIGHT, "gtol": 0.0})
    assert abs(res["obj"] - 1.0) < 1e-8


@pytest.mark.parametrize("impl", ["xla", "mega"])
def test_seeded_maxcut_matches_the_jax_package(impl):
    A = make_random_graph(40, 0.3, seed=4)
    common = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=40.0,
                  printlevel=0, seed=0, dtype="float64")
    ref = j_sdplr(*j_maxcut(A), 4, **common)
    C, As, b = maxcut(A)
    res = sdplr(C, As, b, 4, device="cpu", inner_impl=impl, **common)
    for r in (ref, res):
        assert r["primal_vio"] <= 1e-2
        assert r["rel_duality_gap"] <= 1e-2
    assert abs(res["obj"] - ref["obj"]) / abs(ref["obj"]) < 1e-3
    assert res["inner_engine"] == (ENGINE_PLAIN if impl == "mega"
                                   else ENGINE_TORCH)
    assert set(ref) <= set(res)


def test_cutnorm_all_ones_2x2():
    """CutNorm on the 2×2 all-ones matrix: ⟨-C, X⟩ = 4 at X = 11ᵀ
    (tests/test_e2e.py:92), to 1e-3."""
    C, As, b = cutnorm(sp.csr_matrix(np.ones((2, 2))))
    res = sdplr(C, As, b, 2, fprec=0.0, objtol=1e-5, ptol=1e-6,
                prior_trace_bound=4.0, printlevel=0, maxmajoriter=200,
                device="cpu", dtype="float64")
    assert abs(-res["obj"] - 4.0) < 1e-3


@pytest.mark.parametrize("family,n", [("cutnorm", 20),
                                      ("minimum_bisection", 40)])
def test_seeded_solve_matches_the_jax_package(family, n):
    """Seeded CutNorm (the bipartite lift of an n×n matrix, N = 2n) and
    MinBisection solves against sdplrplus_tpu.sdplr on the same input and
    seed, as the MaxCut one above: both meet ptol and objtol 1e-2 and the
    objectives agree to 1e-3."""
    A = make_random_graph(n, 0.3, seed=4)
    Cj, Asj, bj = getattr(j_models, family)(A)
    N = len(bj)
    common = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=float(N),
                  printlevel=0, seed=0, dtype="float64")
    ref = j_sdplr(Cj, Asj, bj, 4, **common)
    C, As, b = getattr(t_models, family)(A)
    res = sdplr(C, As, b, 4, device="cpu", **common)
    for r in (ref, res):
        assert r["primal_vio"] <= 1e-2
        assert r["rel_duality_gap"] <= 1e-2
    assert abs(res["obj"] - ref["obj"]) / abs(ref["obj"]) < 1e-3
    assert set(ref) <= set(res)


def test_mega_on_an_ineligible_problem_raises():
    from sdplrplus_tpu_torch.models import relaxed_maxcut

    C, As, b = relaxed_maxcut(make_random_graph(12, 0.5, seed=2))
    with pytest.raises((ValueError, NotImplementedError)):
        sdplr(C, As, b, 2, printlevel=0, device="cpu", inner_impl="mega",
              dense_mode=False)
