"""The inequality families and the fast-diagonal engine end to end on the
CPU, against the JAX package.

Relaxed MaxCut with native inequalities reaches K₂'s analytic optimum
(tests/test_e2e.py:106) through the torch inner loop and through K2's
plain version; μ-conductance with native inequalities at n = 100 meets
the tolerances with its box and volume constraints holding
(tests/test_e2e.py:171); the native-scaled μ-conductance and the lifted
equality forms (μ-conductance, its reformulation, relaxed MaxCut) run on
the fast-diagonal engine. Each lands within 1e-2 (relative) of
``sdplrplus_tpu.sdplr``'s objective on the same instance and seed, with
pinfeas ≤ ptol and a certified gap ≤ objtol, in float64.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from sdplrplus_tpu import sdplr as j_sdplr
from sdplrplus_tpu.models import problems as j_models

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.models import problems as t_models
from sdplrplus_tpu_torch.solver.outer import (
    ENGINE_FAST, ENGINE_PLAIN, ENGINE_TORCH,
)

K2 = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 0.0]]))
MU = 0.1
OBJ_RTOL = 1e-2   # two solves certified to objtol = 1e-2 each


@pytest.mark.parametrize("impl,engine", [("xla", ENGINE_TORCH),
                                         ("mega", ENGINE_PLAIN)])
def test_relaxed_maxcut_inequality_on_k2(impl, engine):
    C, As, b, ct = t_models.relaxed_maxcut_ineq(K2)
    res = sdplr(C, As, b, 1, constraint_types=ct, fprec=0.0, objtol=1e-5,
                ptol=1e-6, prior_trace_bound=2.0, printlevel=0,
                maxmajoriter=200, device="cpu", dtype="float64",
                inner_impl=impl)
    assert abs(res["obj"] - (-1.0)) < 1e-3
    assert res["inner_engine"] == engine


def _both(gen, args, r, impl="auto", **kw):
    """The same instance through both packages, float64, seed 0; the port
    on the CPU with ``inner_impl=impl``."""
    out = []
    for solve, models, extra in ((j_sdplr, j_models, {}),
                                 (sdplr, t_models, {"device": "cpu",
                                                    "inner_impl": impl})):
        prob = getattr(models, gen)(*args)
        C, As, b = prob[:3]
        ct = prob[3] if len(prob) == 4 else None
        out.append(solve(C, As, b, r, constraint_types=ct, printlevel=0,
                         seed=0, dtype="float64", **kw, **extra))
    return out


def _check_against(ref, res, ptol=1e-2, objtol=1e-2):
    for r in (ref, res):
        assert r["primal_vio"] <= ptol
        assert r["rel_duality_gap"] <= objtol
    assert abs(res["obj"] - ref["obj"]) <= OBJ_RTOL * abs(ref["obj"])
    assert set(ref) <= set(res)


@pytest.mark.parametrize("impl,engine", [("auto", ENGINE_FAST),
                                         ("mega", ENGINE_PLAIN)])
def test_mu_conductance_inequalities_n100(impl, engine):
    A = j_models.make_random_graph(100, 0.12, seed=5)
    volG = float(A.sum())
    ub = t_models.mu_conductance_ub(volG, MU)
    lb = t_models.mu_conductance_lb(volG, MU)
    kw = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=100 * ub,
              maxmajoriter=200, maxtime=600.0)
    ref, res = _both("mu_conductance_ineq", (A, MU), 5, impl=impl, **kw)
    # the JAX package takes the fast-diagonal engine on the CPU
    assert ref["inner_engine"] == "fast-diag-spmm"
    assert res["inner_engine"] == engine
    _check_against(ref, res)
    # the box lb ≤ X_ii ≤ ub and the volume ⟨D, X⟩ = 1 hold to ptol·‖b‖
    X_diag = np.sum(res["R"] ** 2, axis=1)
    assert np.all(X_diag <= ub + 1e-2) and np.all(X_diag >= lb - 1e-2)
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    assert abs(float(d @ X_diag) - 1.0) <= 2e-2


@pytest.mark.parametrize("gen,dense", [
    ("mu_conductance_native", None),
    ("mu_conductance", None),
    ("mu_conductance_reformulated", None),
    ("relaxed_maxcut", False),
])
def test_fast_diagonal_families_match_the_jax_package(gen, dense):
    A = j_models.make_random_graph(30, 0.5, seed=3)
    ub = t_models.mu_conductance_ub(float(A.sum()), MU)
    lifted = gen in ("mu_conductance", "mu_conductance_reformulated",
                     "relaxed_maxcut")
    if gen == "relaxed_maxcut":
        args, tb = (A,), 30.0
    else:
        args, tb = (A, MU), 30 * ub
    # the 3n lift's slack blocks add to the trace
    tb = 3 * tb if lifted else tb
    ref, res = _both(gen, args, 5, ptol=1e-2, objtol=1e-2,
                     prior_trace_bound=tb, dense_mode=dense)
    assert ref["inner_engine"] == "fast-diag-spmm"
    assert res["inner_engine"] == ENGINE_FAST
    _check_against(ref, res)
