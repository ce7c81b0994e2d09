"""Lovász θ end to end through the port on the CPU (slice D).

The entry-mask engine solves θ to its analytic values (an odd cycle, a
cycle power, a disjoint union), agrees with an independent dense SDP
method at n = 10 and with the JAX package on a seeded n = 20 instance,
float64 and float32 (the latter through the trace rescale), and reports
every key the JAX package reports. Tolerances are stated per test; they
are those of the JAX package's own θ tests (tests/test_e2e.py,
tests/test_cross_validation.py, tests/test_entrymask.py).
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sdplrplus_tpu import sdplr as j_sdplr
from sdplrplus_tpu.models import lovasz_theta as j_lovasz_theta
from sdplrplus_tpu.problem import SDPProblem as JProblem

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.compile import compile_problem
from sdplrplus_tpu_torch.models import (
    lovasz_theta, make_random_graph, synthetic_cliques, synthetic_cycle_power,
)
from sdplrplus_tpu_torch.ops.device import to_device
from sdplrplus_tpu_torch.problem import SDPProblem
from sdplrplus_tpu_torch.solver import major, outer
from sdplrplus_tpu_torch.solver.outer import ENGINE_ENTRY, ENGINE_GENERAL

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "exps"))

from dense_baseline import solve_dense_sdp  # noqa: E402
from oracles import dense_ops  # noqa: E402

CPU = dict(printlevel=0, device="cpu")


def _cycle(n, extra=0):
    """The n-cycle, plus ``extra`` isolated vertices."""
    i = np.arange(n)
    N = n + extra
    return sp.csr_matrix((np.ones(2 * n), (np.r_[i, (i + 1) % n],
                                           np.r_[(i + 1) % n, i])),
                         shape=(N, N))


def test_theta_of_the_five_cycle():
    """θ(C₅) = √5 to 1e-3 (tests/test_e2e.py:73). At n = 5 the trace
    constraint has 5 entries, under compile_problem's wide threshold of 8,
    so C₅ alone compiles to the general engine. θ is additive over
    disjoint unions and θ(K₁) = 1, so C₅ plus four isolated vertices
    (n = 9, entry mode) must give √5 + 4."""
    C, As, b = lovasz_theta(_cycle(5))
    res = sdplr(C, As, b, 3, fprec=0.0, objtol=1e-5, ptol=1e-6,
                prior_trace_bound=1.0, maxmajoriter=200, dtype="float64",
                **CPU)
    assert res["inner_engine"] == ENGINE_GENERAL
    assert abs(-res["obj"] - np.sqrt(5.0)) < 1e-3
    C, As, b = lovasz_theta(_cycle(5, extra=4))
    res = sdplr(C, As, b, 3, fprec=0.0, objtol=1e-5, ptol=1e-6,
                prior_trace_bound=1.0, maxmajoriter=200, dtype="float64",
                **CPU)
    assert res["inner_engine"] == ENGINE_ENTRY
    assert abs(-res["obj"] - (np.sqrt(5.0) + 4.0)) < 1e-3


def test_theta_matches_the_dense_baseline():
    """n = 10 against the alternating-projection SDP method of
    exps/dense_baseline.py, 1e-2 relative
    (tests/test_cross_validation.py:42)."""
    A = make_random_graph(10, 0.5, seed=3)
    C, As, b = lovasz_theta(A)
    dense = dense_ops(JProblem(*j_lovasz_theta(A), None))
    obj_ref, vio_ref, _ = solve_dense_sdp(dense[-1], dense[:-1], b)
    assert vio_ref < 1e-6
    res = sdplr(C, As, b, 4, ptol=1e-4, objtol=1e-3, prior_trace_bound=1.0,
                maxmajoriter=300, dtype="float64", **CPU)
    assert res["inner_engine"] == ENGINE_ENTRY
    assert abs(res["obj"] - obj_ref) / max(1.0, abs(obj_ref)) < 1e-2


@pytest.mark.parametrize("graph,theta", [
    (lambda: synthetic_cycle_power(24, 2), 8.0),
    (lambda: synthetic_cliques(24, 3), 8.0),
])
def test_theta_analytic_instances(graph, theta):
    """θ(C₂₄²) = 24/3 and θ(8 K₃) = 24/3 exactly (exps/run.py:93-122),
    to 1e-3 relative, with a certified gap ≤ 1e-3."""
    C, As, b = lovasz_theta(graph())
    res = sdplr(C, As, b, 4, ptol=1e-3, objtol=1e-3, prior_trace_bound=1.0,
                dtype="float64", seed=0, **CPU)
    assert res["inner_engine"] == ENGINE_ENTRY
    assert abs(-res["obj"] - theta) / theta < 1e-3
    assert res["primal_vio"] <= 1e-3 and res["rel_duality_gap"] <= 1e-3
    # the certificate is an upper bound on the feasible side too
    assert -res["max_dual_value"] >= theta - 1e-9


@pytest.mark.parametrize("dtype,graph,tol", [
    ("float64", lambda: make_random_graph(20, 0.5, seed=1), 1e-3),
    ("float32", lambda: synthetic_cycle_power(72, 2), 1e-2),
])
def test_seeded_theta_matches_the_jax_package(dtype, graph, tol):
    """A seeded θ solve against sdplrplus_tpu.sdplr on the same input and
    seed (tests/test_torch_e2e.py:53-67): both meet ptol and objtol 1e-2,
    the objectives agree to 1e-3 in float64 and to 1e-2 in float32, whose
    trajectories part by rounding. The float64 instance certifies with
    room in both packages (gaps of 5e-5 and 2e-4 in a seeded check): a
    random θ instance whose gap lands near 1e-2 (n = 24, p = 0.3: 9.3e-3)
    crosses it when thread counts change the summation order. The
    float32 instance is C₇₂² (θ = 24):
    at n = 72 both packages solve the trace-rescaled problem (f = n ≥ 64)
    and map it back. (On a random graph of that size neither package
    certifies 1e-2 in float32 within minutes: the rigorous certificate is
    loose there, ROADMAP F7.)"""
    A = graph()
    n = A.shape[0]
    common = dict(ptol=1e-2, objtol=1e-2, prior_trace_bound=1.0,
                  printlevel=0, seed=0, dtype=dtype, maxtime=120.0)
    ref = j_sdplr(*j_lovasz_theta(A), 4, **common)
    C, As, b = lovasz_theta(A)
    res = sdplr(C, As, b, 4, device="cpu", **common)
    for r in (ref, res):
        assert r["primal_vio"] <= 1e-2
        assert r["rel_duality_gap"] <= 1e-2
    assert abs(res["obj"] - ref["obj"]) / abs(ref["obj"]) < tol
    assert res["inner_engine"] == ENGINE_ENTRY
    assert set(ref) <= set(res)
    if n >= 64:
        assert res["entry_rescale_f"] == ref["entry_rescale_f"] == float(n)
        assert abs(-res["obj"] - n / 3) / (n / 3) < 1e-3
        # the factor is back in the user's scale: Tr(RRᵀ) = 1 to ptol
        assert abs(np.sum(res["R"] ** 2) - 1.0) <= 1e-2


def test_entry_termination_objective_matches_its_host_mirror():
    """The state machine's entry certificate (major.entry_certified_obj,
    torch) and the host mirror (outer._entry_term_obj, numpy float64) on
    the same violations, with the repair affordable and not."""
    A = make_random_graph(20, 0.4, seed=2)
    dp = to_device(compile_problem(SDPProblem(*lovasz_theta(A), None)),
                   torch.float64, "cpu")
    assert dp.entry_trace_cert
    rng = np.random.default_rng(0)
    for scale, objtol in ((1e-6, 1e-2), (1e-2, 1e-6), (1.0, 1e-2)):
        vio = scale * rng.normal(size=dp.m + 1)
        vio[dp.m] = -3.0
        for rel in (True, False):
            got = float(major.entry_certified_obj(
                dp, torch.tensor(vio), torch.tensor(objtol, dtype=torch.float64),
                rel))
            want = outer._entry_term_obj(dp, vio, objtol, rel)
            assert abs(got - want) <= 1e-10 * max(1.0, abs(want))


def test_feasible_objective_of_the_greedy_rounding():
    """On C₂₄² an independent set of size 8 scaled to Tr = 1 has objective
    −8: _greedy_is_objective finds one from a factor that puts its weight
    on the optimal support."""
    A = synthetic_cycle_power(24, 2)
    prob = SDPProblem(*lovasz_theta(A), None)
    dp = to_device(compile_problem(prob), torch.float64, "cpu")
    R = np.full((24, 1), 1e-3)
    R[::3] = 1.0
    assert outer._greedy_is_objective(prob, dp, R) == pytest.approx(-8.0)


@pytest.mark.parametrize("rescale", [False, True])
def test_entry_eig_certificate_is_a_feasible_point(rescale):
    """outer._entry_eig_cert on θ of C₇₂² (θ = 24), plain and
    trace-rescaled (f = 72), at a random factor and near the optimal one
    (every third vertex, θ's independent set, plus 1e-5 noise): the point
    it charges, (1 − t)·M + t·c·I with M = s·RRᵀ zeroed on the edges and
    δ = −λ_min(M) from numpy's full eigvalsh, is PSD (λ_min ≥ −1e-12 of
    its trace), meets the trace constraint to 1e-12 and every edge
    exactly, and has the returned objective (or c·I's, where that is
    lower) to 1e-10 (relative); it is no
    looser than the same repair at δ = ‖E‖_F (E = s·RRᵀ on the edges, the
    bound the JAX package's repair takes), and near the optimum it lies
    within 1e-3 of −θ."""
    A = synthetic_cycle_power(72, 2)
    prob = SDPProblem(*lovasz_theta(A), None)
    if rescale:
        prob, _, f = outer._maybe_rescale_entry(prob, outer.SolverConfig())
        assert f == 72.0
    dp = to_device(compile_problem(prob), torch.float64, "cpu")
    assert dp.entry_trace_cert
    n = dp.n
    rng = np.random.default_rng(1)
    near = 1e-5 * rng.standard_normal((n, 6))
    near[::3, 0] += 1.0
    for R in (rng.standard_normal((n, 6)), near):
        cert = outer._entry_eig_cert(prob, dp, R)
        b_w = float(dp.b[dp.extra_gids[0]])
        X = R @ R.T
        M = (b_w / np.trace(X)) * X
        rows, cols = A.nonzero()
        M[rows, cols] = 0.0
        delta = max(0.0, -np.linalg.eigvalsh(M)[0])
        c = b_w / n
        t = delta / (delta + c)
        Xt = (1.0 - t) * M + t * c * np.eye(n)
        assert np.linalg.eigvalsh(Xt)[0] >= -1e-12 * np.trace(Xt)
        assert abs(np.trace(Xt) - b_w) <= 1e-12 * b_w
        assert np.all(Xt[rows, cols] == 0.0)
        C = prob.C
        obj = lambda Y: float(np.sum(C.d * np.sum(C.B * (Y @ C.B), axis=0)))
        # c·I is feasible too, and better far from the optimum
        mix = obj(c * np.eye(n))
        want = min(obj(Xt), mix)
        assert abs(cert - want) <= 1e-10 * abs(want)
        d_f = np.linalg.norm((b_w / np.trace(X)) * X - M)
        t_f = d_f / (d_f + c)
        frob = min((1.0 - t_f) * obj(M) + t_f * mix, mix)
        assert cert <= frob + 1e-12 * abs(frob)
    assert abs(-cert - 24.0) <= 1e-3 * 24.0


@pytest.mark.slow
def test_theta_odd_cycle_201_analytic():
    """θ(C_n) = n·cos(π/n)/(1 + cos(π/n)) at n = 201 (Lovász 1979,
    Thm. 5), 1e-2 relative (tests/test_cross_validation.py:114)."""
    n = 201
    C, As, b = lovasz_theta(_cycle(n))
    res = sdplr(C, As, np.asarray(b, float), 10, ptol=1e-4, objtol=1e-2,
                prior_trace_bound=1.0, maxtime=600.0, maxmajoriter=500,
                dtype="float64", **CPU)
    theta_true = n * np.cos(np.pi / n) / (1.0 + np.cos(np.pi / n))
    assert abs(-res["obj"] - theta_true) / theta_true <= 1e-2
