"""The general inner engine of the port (ops/forward.py ``uv_values_uv``,
the general ``A_uv`` and ``A_linesearch``; solver/inner.py without the
carried C@R) against the JAX package's ``xla-general`` engine, against
the dense oracles of tests/oracles.py and against the port's own fast
products.

The same inputs, made from a seed with numpy, go through the JAX
function and the port's, in float64 on the CPU. Tolerances, stated per
test: operators to 1e-10 (relative, with an absolute floor of 1e-12),
as tests/test_coreop.py holds the JAX package against its oracles; the
gradient against central finite differences to 1e-7 of its largest
entry (test_coreop.py:98); 25 inner steps to 1e-9; end-to-end
objectives to 1e-3 (tests/test_entrymask.py:161-172).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdplrplus_tpu import sdplr as j_sdplr
from sdplrplus_tpu.compile import compile_problem as j_compile
from sdplrplus_tpu.models import problems as j_models
from sdplrplus_tpu.ops import adjoint as j_adjoint
from sdplrplus_tpu.ops import forward as j_forward
from sdplrplus_tpu.ops.device import to_device as j_to_device
from sdplrplus_tpu.problem import SDPProblem as JProblem
from sdplrplus_tpu.solver import inner as j_inner
from sdplrplus_tpu.solver.al import al_value_grad as j_al_value_grad
from sdplrplus_tpu.solver.lbfgs import lbfgs_init as j_lbfgs_init

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.compile import compile_problem as t_compile
from sdplrplus_tpu_torch.models import problems as t_models
from sdplrplus_tpu_torch.ops import adjoint as t_adjoint
from sdplrplus_tpu_torch.ops import forward as t_forward
from sdplrplus_tpu_torch.ops.device import (
    fast_diag_eligible, to_device as t_to_device,
)
from sdplrplus_tpu_torch.ops.spmm import spmm_C
from sdplrplus_tpu_torch.problem import SDPProblem as TProblem
from sdplrplus_tpu_torch.solver import inner as t_inner
from sdplrplus_tpu_torch.solver.al import (
    al_value, al_value_grad as t_al_value_grad,
)
from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init as t_lbfgs_init
from sdplrplus_tpu_torch.solver.linesearch import exact_linesearch
from sdplrplus_tpu_torch.solver.outer import ENGINE_ENTRY, ENGINE_GENERAL

from oracles import dense_al, dense_ops, dense_primal_vio, dense_S, \
    fd_gradient

F64 = torch.float64
CASES = [(5, 0.4, 2), (8, 0.7, 3), (12, 0.5, 2)]
CPU = dict(device="cpu", printlevel=0)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _close(got, want, rtol=1e-10, atol=1e-12):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _theta_ineq(A, models):
    """θ with its edge constraints as inequalities X_ij ≤ 0 (the trace
    stays an equality): off-diagonal entries on the Armijo path."""
    C, As, b = models.lovasz_theta(A)
    return C, As, b, np.r_[np.ones(len(b) - 1, bool), False]


def _pair(n, p, seed, ineq=False):
    """(JAX DeviceProblem, port DeviceProblem, the JAX SDPProblem) of θ
    on make_random_graph(n, p, seed), both compiled on the general path."""
    A = j_models.make_random_graph(n, p, seed=seed)
    if ineq:
        Cj, Asj, bj, ct = _theta_ineq(A, j_models)
        Ct, Ast, bt, _ = _theta_ineq(A, t_models)
    else:
        (Cj, Asj, bj), (Ct, Ast, bt), ct = (j_models.lovasz_theta(A),
                                            t_models.lovasz_theta(A), None)
    pj = JProblem(Cj, Asj, np.asarray(bj, np.float64), ct)
    cp_j = j_compile(pj, entry=False, dense=False)
    cp_t = t_compile(TProblem(Ct, Ast, np.asarray(bt, np.float64), ct),
                     entry=False, dense=False)
    dp_t = t_to_device(cp_t, F64, "cpu")
    assert t_forward.is_general(dp_t)
    return j_to_device(cp_j, jnp.float64), dp_t, pj


def _padded(X, n_pad):
    Xp = np.zeros((n_pad, X.shape[1]))
    Xp[: X.shape[0]] = X
    return Xp


# --------------------------------------------------------------- operators

@pytest.mark.parametrize("n,p,r", CASES)
def test_general_operators_match_jax_and_the_oracles(n, p, r):
    """A_uu, A_uv, A_linesearch and S·X on θ (test_coreop.py:59-138's
    θ rows): the port's general engine against the JAX package's and
    against the dense evaluations."""
    dp_j, dp_t, prob = _pair(n, p, seed=n + r)
    rng = np.random.default_rng(7)
    U, V = rng.uniform(-1, 1, (2, n, r))
    Up, Vp = _padded(U, dp_t.n_pad), _padded(V, dp_t.n_pad)
    ops = dense_ops(prob)
    dense = lambda X: np.array([np.sum(Ai * X) for Ai in ops])

    av = t_forward.A_uu(dp_t, _t(Up))
    _close(av, j_forward.A_uu(dp_j, jnp.asarray(Up)))
    _close(av, dense(U @ U.T))
    auv = t_forward.A_uv(dp_t, _t(Up), _t(Vp))
    _close(auv, j_forward.A_uv(dp_j, jnp.asarray(Up), jnp.asarray(Vp)))
    _close(auv, dense(0.5 * (U @ V.T + V @ U.T)))
    A_RD, A_DD = t_forward.A_linesearch(dp_t, _t(Up), _t(Vp))
    J_RD, J_DD = j_forward.A_linesearch(dp_j, jnp.asarray(Up),
                                        jnp.asarray(Vp))
    _close(A_RD, J_RD)
    _close(A_DD, J_DD)
    _close(A_RD, dense(U @ V.T + V @ U.T))
    _close(A_DD, dense(V @ V.T))

    y = rng.normal(size=dp_t.m + 1)
    SX = t_adjoint.apply_S(dp_t, _t(y), _t(Up))
    _close(SX, j_adjoint.apply_S(dp_j, j_adjoint.assemble_s_tri(
        dp_j, jnp.asarray(y)), jnp.asarray(y), jnp.asarray(Up)))
    _close(SX[:n], dense_S(prob, y) @ U)
    assert float(SX[n:].abs().max()) == 0.0


@pytest.mark.parametrize("n,p,r", CASES[:2])
def test_general_gradient_matches_finite_differences(n, p, r):
    """G = 2·S·R against central differences of the dense AL
    (test_coreop.py:92-116), and against the JAX package's gradient."""
    dp_j, dp_t, prob = _pair(n, p, seed=n * r)
    rng = np.random.default_rng(11)
    R = rng.uniform(-1, 1, size=(n, r))
    Rp = _padded(R, dp_t.n_pad)
    lam, sigma = rng.normal(size=prob.m), 2.0
    _, vio = al_value(dp_t, _t(Rp), _t(lam), sigma)
    G, _ = t_adjoint.gradient(dp_t, _t(Rp), _t(lam), sigma, vio)
    G_j, _, _ = j_adjoint.gradient(dp_j, jnp.asarray(Rp), jnp.asarray(lam),
                                   sigma, jnp.asarray(vio.numpy()))
    _close(G, G_j)
    G = G.numpy()[:n]
    G_fd = fd_gradient(prob, R, lam, sigma)
    assert np.max(np.abs(G - G_fd)) / (1.0 + np.max(np.abs(G))) < 1e-7


@pytest.mark.parametrize("n,p,r", CASES)
def test_general_linesearch_commit_invariant(n, p, r):
    """After the exact step, the algebraically updated violations equal a
    fresh dense evaluation at R + αD, and the AL does not rise
    (test_coreop.py:135-160)."""
    _, dp_t, prob = _pair(n, p, seed=n)
    rng = np.random.default_rng(17)
    R = rng.uniform(-1, 1, size=(n, r))
    Rp = _t(_padded(R, dp_t.n_pad))
    lam, sigma = torch.zeros(prob.m, dtype=F64), 2.0
    _, vio = al_value(dp_t, Rp, lam, sigma)
    G, _ = t_adjoint.gradient(dp_t, Rp, lam, sigma, vio)
    alpha, f_star, new_vio = exact_linesearch(dp_t, Rp, -G, vio, lam, sigma)
    R_new = (Rp - alpha * G).numpy()[:n]
    assert np.max(np.abs(new_vio.numpy() - dense_primal_vio(prob, R_new))) \
        < 1e-9
    assert float(f_star) <= dense_al(prob, R, np.zeros(prob.m), sigma) \
        + 1e-10


def _diag_problems():
    A = j_models.make_random_graph(14, 0.5, seed=7)
    return [
        ("maxcut", t_models.maxcut(A) + (None,)),
        ("cutnorm", t_models.cutnorm(np.abs(np.asarray(A.todense())))
         + (None,)),
        ("minbis", t_models.minimum_bisection(A) + (None,)),
        ("mu_cond", t_models.mu_conductance(A, 0.3) + (None,)),
        ("mu_cond_ineq", t_models.mu_conductance_ineq(A, 0.3)),
    ]


@pytest.mark.parametrize("name,prob", _diag_problems(),
                         ids=[p[0] for p in _diag_problems()])
def test_fast_products_match_the_general_form(name, prob):
    """On all-diagonal problems (fast-diagonal engine) the products from
    the one SpMM CD = C@D equal the general form on the same compiled
    problem: 𝒜 through ``_reduce(uv_values_uv(…))`` and S·X through
    ``apply_S_general`` (tests/test_fast_diag.py:61), to 1e-10."""
    C, As, b, ct = prob
    cp = t_compile(TProblem(C, list(As), np.asarray(b, float), ct),
                   dense=False)
    dp = t_to_device(cp, F64, "cpu")
    assert fast_diag_eligible(dp) and not t_forward.is_general(dp)
    rng = np.random.default_rng(0)
    R, D = (_t(_padded(rng.standard_normal((cp.n, 3)), cp.n_pad))
            for _ in range(2))
    general = lambda U, V, s: t_forward._add_lowrank(
        s * t_forward._reduce(dp, t_forward.uv_values_uv(dp, U, V)), dp, U, V,
        s)
    A_RD, A_DD = t_forward.A_linesearch_cd(dp, R, D, spmm_C(dp, D))
    _close(A_RD, general(R, D, 2.0), atol=1e-10)
    _close(A_DD, general(D, D, 1.0), atol=1e-10)
    _close(t_forward.A_uu_cx(dp, R, spmm_C(dp, R)), general(R, R, 1.0),
           atol=1e-10)
    _close(t_forward.A_uv(dp, R, D), general(R, D, 1.0), atol=1e-10)
    _close(t_forward.uv_values_uv(dp, R, R), t_forward.uv_values_uu(dp, R))
    y = _t(rng.standard_normal(cp.m + 1))
    _close(t_adjoint.apply_S(dp, y, R), t_adjoint.apply_S_general(dp, y, R),
           atol=1e-10)


# -------------------------------------------------------------- inner loop

@pytest.mark.parametrize("ineq", [False, True], ids=["equality", "armijo"])
def test_general_inner_loop_matches_jax(ineq):
    """25 inner steps of the general engine in float64 (exact line search
    on θ; Armijo on θ with inequality edges), stagnation test off, against
    the JAX package's ``xla-general`` loop (tests/test_fast_diag.py:108):
    R, G, the violations and L to 1e-9."""
    dp_j, dp_t, _ = _pair(20, 0.4, seed=3, ineq=ineq)
    assert dp_t.has_inequalities == ineq
    rng = np.random.default_rng(1)
    r, k = 3, 4
    R0 = _padded(rng.uniform(-1, 1, size=(dp_t.n, r)), dp_t.n_pad)
    lam = np.zeros(dp_t.m)
    L, vio, G, y, gn, _ = j_al_value_grad(dp_j, jnp.asarray(R0),
                                          jnp.asarray(lam), jnp.asarray(2.0),
                                          True, True)
    cj, vnj = j_inner.inner_chunk(
        dp_j, jnp.asarray(R0), G, y, vio, L, gn,
        j_lbfgs_init(k, dp_j.n_pad, r, jnp.float64), jnp.asarray(lam),
        jnp.asarray(2.0), jnp.asarray(1e-14), jnp.asarray(-np.inf), 25, k=k,
        use_armijo=ineq, gtol_relative=True, ptol_relative=True)
    Lt, viot, Gt, yt, gnt, _ = t_al_value_grad(dp_t, _t(R0), _t(lam),
                                               _t(2.0), True, True)
    _close(Gt, G)
    ct, vnt = t_inner.inner_chunk(
        dp_t, _t(R0), Gt, yt, viot, Lt, gnt,
        t_lbfgs_init(k, dp_t.n_pad, r, F64), _t(lam), _t(2.0), 1e-14,
        float("-inf"), 25, k=k, use_armijo=ineq, gtol_relative=True,
        ptol_relative=True)
    assert ct.steps == int(cj.steps) == 25
    for name in ("R", "G", "vio_raw", "L_val"):
        _close(getattr(ct, name), getattr(cj, name), rtol=1e-9, atol=1e-12)
    _close(vnt, vnj, rtol=1e-9)


# ------------------------------------------------------------- end to end

def test_theta_without_entry_mode_matches_jax_and_the_entry_engine():
    """θ of make_random_graph(10, 0.5, seed=7) with entry_mode=False, in
    float64: the port's general solve within 1e-3 of the JAX package's
    general solve and of the port's own entry-mode solve
    (tests/test_entrymask.py:161-172)."""
    A = j_models.make_random_graph(10, 0.5, seed=7)
    kw = dict(ptol=1e-3, objtol=1e-3, prior_trace_bound=1.0,
              dtype="float64", printlevel=0, maxmajoriter=200)
    res = sdplr(*t_models.lovasz_theta(A), 3, entry_mode=False, device="cpu",
                **kw)
    ent = sdplr(*t_models.lovasz_theta(A), 3, device="cpu", **kw)
    ref = j_sdplr(*j_models.lovasz_theta(A), 3, entry_mode=False, **kw)
    assert res["inner_engine"] == ENGINE_GENERAL
    assert ent["inner_engine"] == ENGINE_ENTRY
    assert ref["inner_engine"] == "xla-general"
    assert res["primal_vio"] <= 1e-3
    for other in (ref, ent):
        assert abs(res["obj"] - other["obj"]) < 1e-3 * abs(other["obj"])
    assert set(ref) <= set(res)


def test_cycle_power_10000_takes_the_general_engine():
    """θ of C₁₀₀₀₀⁹ (chip_smoke.py phase 14's instance) on the CPU: compile
    picks the general engine (n_pad 10,112 > 8192) and a short float32
    solve runs on it, with a finite objective and a certified bound that
    does not pass the analytic optimum θ = 1000. maxtime 20 s keeps the
    host dual polish and the reseeds out (they need 30 and 60 s left)."""
    A = t_models.synthetic_cycle_power(10000, 9)
    C, As, b = t_models.lovasz_theta(A)
    cp = t_compile(TProblem(C, As, np.asarray(b, np.float64), None))
    assert cp.ew_c2 is None and cp.C_dense is None
    assert (cp.n_pad, cp.m, cp.P_pad) == (10112, 90001, 100096)
    res = sdplr(C, As, b, 4, ptol=1e-2, objtol=1e-2, prior_trace_bound=1.0,
                dtype="float32", maxiter=30, maxtime=20.0, **CPU)
    assert res["inner_engine"] == ENGINE_GENERAL
    assert res["entry_rescale_f"] == 10000.0
    assert np.isfinite(res["obj"]) and res["iter"] >= 30
    assert res["max_dual_value"] <= -1000.0 * (1.0 - 1e-4)
