"""The port's inequality path and fast-diagonal engine against the JAX
package, module by module, in float64 on the CPU.

μ-conductance with native inequalities (the graph of
tests/test_megakernel.py's ``_mucond_setup``) keeps C sparse (its wide
volume constraint), so it runs the fast-diagonal engine with the carried
CX = C@R; relaxed MaxCut with native inequalities runs it too when C is
kept sparse, and the dense engine otherwise; the lifted relaxed MaxCut
is an equality problem on the fast-diagonal engine. The same numpy
inputs go through both packages; results agree to rtol 1e-10 unless a
test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sdplrplus_tpu.compile import compile_problem as j_compile
from sdplrplus_tpu.models import problems as j_models
from sdplrplus_tpu.ops import adjoint as j_adjoint
from sdplrplus_tpu.ops import forward as j_forward
from sdplrplus_tpu.ops import lanczos as j_lanczos
from sdplrplus_tpu.ops.device import to_device as j_to_device
from sdplrplus_tpu.ops.spmm import spmm_C as j_spmm_C
from sdplrplus_tpu.problem import SDPProblem as JProblem
from sdplrplus_tpu.solver import dualbound as j_dualbound
from sdplrplus_tpu.solver import inner as j_inner
from sdplrplus_tpu.solver import lbfgs as j_lbfgs
from sdplrplus_tpu.solver import major as j_major
from sdplrplus_tpu.solver.al import (
    al_value_grad as j_al_value_grad, al_value_grad_cx as j_al_value_grad_cx,
)
from sdplrplus_tpu.solver.linesearch import (
    armijo_linesearch as j_armijo_linesearch,
)

from sdplrplus_tpu_torch import convert
from sdplrplus_tpu_torch.compile import compile_problem as t_compile
from sdplrplus_tpu_torch.models import problems as t_models
from sdplrplus_tpu_torch.ops import adjoint as t_adjoint
from sdplrplus_tpu_torch.ops import forward as t_forward
from sdplrplus_tpu_torch.ops import megakernel as mk
from sdplrplus_tpu_torch.ops.device import (
    fast_diag_eligible, to_device as t_to_device,
)
from sdplrplus_tpu_torch.ops.spmm import spmm_C as t_spmm_C
from sdplrplus_tpu_torch.problem import SDPProblem as TProblem
from sdplrplus_tpu_torch.solver import dualbound as t_dualbound
from sdplrplus_tpu_torch.solver import inner as t_inner
from sdplrplus_tpu_torch.solver import lbfgs as t_lbfgs
from sdplrplus_tpu_torch.solver import major as t_major
from sdplrplus_tpu_torch.solver.al import (
    al_value_grad as t_al_value_grad, al_value_grad_cx as t_al_value_grad_cx,
)
from sdplrplus_tpu_torch.solver.linesearch import (
    ARMIJO_C, ARMIJO_MAX_HALVINGS, armijo_linesearch as t_armijo_linesearch,
)

from test_torch_modules import _close, _fields

F64 = torch.float64
MU = 0.1
# (generator, dense): dense=None lets compile_problem choose (sparse C for
# μ-conductance, whose wide constraint rules dense mode out)
CASES = {
    "mucond": ("mu_conductance_ineq", None),
    "mucond_native": ("mu_conductance_native", None),
    "relaxed_ineq_sparse": ("relaxed_maxcut_ineq", False),
    "relaxed_ineq_dense": ("relaxed_maxcut_ineq", True),
    "relaxed_lifted_sparse": ("relaxed_maxcut", False),
}
FAST = ("mucond", "mucond_native", "relaxed_ineq_sparse",
        "relaxed_lifted_sparse")


def mucond_graph(n=60, seed=2):
    """The graph of tests/test_megakernel.py::_mucond_setup."""
    rng_A = sp.random(n, n, density=0.12, random_state=seed)
    A = ((rng_A + rng_A.T) > 0).astype(float)
    A.setdiag(0)
    A.eliminate_zeros()
    return sp.csr_matrix(A)


def _generate(models, gen, A):
    if gen.startswith("mu_conductance"):
        out = getattr(models, gen)(A, MU)
    else:
        out = getattr(models, gen)(A)
    C, As, b = out[:3]
    return C, list(As), np.asarray(b, np.float64), \
        (out[3] if len(out) == 4 else None)


def feasible_scale_factor(gen, A, R):
    """R (n, r) moved to the feasible region's scale: for μ-conductance
    d-centred (dᵀX d = 0) and scaled to ⟨D, X⟩ = 1, which puts diag(X)
    inside its box; for relaxed MaxCut rows of norm 1/1.01. From an
    unscaled uniform R the box violations are 10⁴× the box and the AL
    10⁹, and even float64 trajectories part after a few steps."""
    if gen.startswith("mu_conductance"):
        d = np.asarray(A.sum(axis=1)).reshape(-1)
        R = R - np.outer(np.ones(len(d)), d @ R / d.sum())
        return R / np.sqrt(np.sum(d * np.sum(R * R, axis=1)))
    if gen == "relaxed_maxcut_ineq":
        return R / (1.01 * np.linalg.norm(R, axis=1, keepdims=True))
    return R


def setup_case(case, r=4, seed=0, scale=1.0, dtypes=(jnp.float64, F64)):
    """Both packages' DeviceProblem (float64 unless ``dtypes`` says
    otherwise) and a start state: R uniform on the real rows at ``scale``
    times the feasible region's scale (0: unscaled), λ small and within
    its upper bound."""
    gen, dense = CASES[case]
    A = mucond_graph()
    cp_j = j_compile(JProblem(*_generate(j_models, gen, A)), dense=dense)
    cp_t = t_compile(TProblem(*_generate(t_models, gen, A)), dense=dense)
    dp_j = j_to_device(cp_j, dtypes[0])
    dp_t = t_to_device(cp_t, dtypes[1], "cpu")
    rng = np.random.default_rng(seed)
    R0 = np.zeros((dp_j.n_pad, r))
    R0[: dp_j.n] = rng.uniform(-1, 1, (dp_j.n, r))
    if scale:
        R0[: A.shape[0]] = scale * feasible_scale_factor(gen, A,
                                                         R0[: A.shape[0]])
    lam = np.minimum(0.01 * rng.standard_normal(dp_j.m),
                     np.asarray(dp_j.lam_ub))
    return dp_j, dp_t, R0, lam


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _j(x):
    return jnp.asarray(np.asarray(x), jnp.float64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_selection_matches(case):
    dp_j, dp_t, _, _ = setup_case(case)
    assert (dp_t.C_dense is None) == (dp_j.C_dense is None)
    assert fast_diag_eligible(dp_t) == (case in FAST)
    assert dp_t.has_inequalities == ("ineq" in case or "mucond" in case)


# ------------------------------------------------------------ operators


@pytest.mark.parametrize("case", FAST)
def test_fast_diagonal_operators_match(case):
    dp_j, dp_t, R0, lam = setup_case(case)
    rng = np.random.default_rng(5)
    D = rng.standard_normal(R0.shape)
    D[dp_j.n:] = 0.0
    CX_j, CD_j = j_spmm_C(dp_j, _j(R0)), j_spmm_C(dp_j, _j(D))
    CX_t, CD_t = t_spmm_C(dp_t, _t(R0)), t_spmm_C(dp_t, _t(D))
    _close(CX_t, CX_j, atol=1e-12)
    _close(t_forward.A_uu_cx(dp_t, _t(R0), CX_t),
           j_forward.A_uu_cx(dp_j, _j(R0), CX_j), atol=1e-12)
    for got, want, name in zip(
            t_forward.A_linesearch_cd(dp_t, _t(R0), _t(D), CD_t),
            j_forward.A_linesearch_cd(dp_j, _j(R0), _j(D), CD_j),
            ("A_RD", "A_DD")):
        _close(got, want, atol=1e-12, what=name)
    # A_uu / A_uv: the JAX package gathers through the general engine
    # (_reduce of uv_values_*), the port through one SpMM; same values
    _close(t_forward.A_uu(dp_t, _t(R0)), j_forward.A_uu(dp_j, _j(R0)),
           atol=1e-12)
    _close(t_forward.A_uv(dp_t, _t(R0), _t(D)),
           j_forward.A_uv(dp_j, _j(R0), _j(D)), atol=1e-12)
    y = np.concatenate([rng.standard_normal(dp_j.m), [1.0]])
    want = j_adjoint.apply_S(dp_j, jnp.zeros((1,)), _j(y), _j(D))
    _close(t_adjoint.apply_S(dp_t, _t(y), _t(D)), want, atol=1e-12)
    _close(t_adjoint.apply_S_cx(dp_t, _t(y), _t(D), CD_t),
           j_adjoint.apply_S_cx(dp_j, _j(y), _j(D), CD_j), atol=1e-12)
    vio = np.array(j_forward.A_uu(dp_j, _j(R0)))
    vio[: dp_j.m] -= np.asarray(dp_j.b)
    for got, want, name in zip(
            t_adjoint.gradient_cx(dp_t, _t(R0), CX_t, _t(lam), _t(2.0),
                                  _t(vio)),
            j_adjoint.gradient_cx(dp_j, _j(R0), CX_j, _j(lam), _j(2.0),
                                  _j(vio)), ("G", "y_full")):
        _close(got, want, atol=1e-12, what=name)


@pytest.mark.parametrize("case", FAST)
def test_al_value_grad_cx_matches(case):
    dp_j, dp_t, R0, lam = setup_case(case)
    want = j_al_value_grad_cx(dp_j, _j(R0), _j(lam), _j(2.0), True, True)
    got = t_al_value_grad_cx(dp_t, _t(R0), _t(lam), _t(2.0), True, True)
    for g, w, name in zip(got, want, ("L", "vio_raw", "G", "y_full",
                                       "grad_norm", "vio_norm", "CX")):
        _close(g, w, atol=1e-12, what=name)
    # the plain fg! agrees with the carried-CX form
    for g, w in zip(t_al_value_grad(dp_t, _t(R0), _t(lam), _t(2.0), True,
                                    True), got):
        _close(g, w.numpy(), rtol=1e-12, atol=1e-12)


# ------------------------------------------------------- the line search


@pytest.mark.parametrize("case", ["mucond", "mucond_native",
                                  "relaxed_ineq_dense"])
@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_armijo_linesearch_matches(case, scale):
    dp_j, dp_t, R0, lam = setup_case(case)
    _, vio, G, y, _, _ = j_al_value_grad(dp_j, _j(R0), _j(lam), _j(2.0), True,
                                         True)
    # a long step (many halvings) and a short one (the first candidate)
    D = -np.asarray(G) * scale
    want = j_armijo_linesearch(dp_j, _j(R0), _j(D), vio, _j(lam), _j(2.0), y)
    got = t_armijo_linesearch(dp_t, _t(R0), _t(D), _t(vio), _t(lam), _t(2.0),
                              _t(y))
    for g, w, name in zip(got, want, ("alpha", "L", "vio_raw")):
        _close(g, w, atol=1e-12, what=name)
    assert ARMIJO_C == 1e-4 and ARMIJO_MAX_HALVINGS == 50


def test_armijo_gives_up_after_fifty_halvings():
    """An ascent direction never passes the test: α = 2⁻⁵⁰ in both."""
    dp_j, dp_t, R0, lam = setup_case("mucond")
    _, vio, G, y, _, _ = j_al_value_grad(dp_j, _j(R0), _j(lam), _j(2.0), True,
                                         True)
    D = np.asarray(G)
    want = j_armijo_linesearch(dp_j, _j(R0), _j(D), vio, _j(lam), _j(2.0), y)
    got = t_armijo_linesearch(dp_t, _t(R0), _t(D), _t(vio), _t(lam), _t(2.0),
                              _t(y))
    assert float(got[0]) == float(want[0]) == 2.0 ** -50
    _close(got[1], want[1])


# ------------------------------------------------------------ inner loop


def _j_carry(dp_j, R0, lam, k, with_cx):
    fg = j_al_value_grad_cx if with_cx else j_al_value_grad
    out = fg(dp_j, _j(R0), _j(lam), _j(2.0), True, True)
    L, vio, G, y, gn = out[:5]
    return j_inner.InnerCarry(
        R=_j(R0), G=G, y_full=y, vio_raw=vio, L_val=L, grad_norm=gn,
        lbfgs=j_lbfgs.lbfgs_init(max(k, 1), dp_j.n_pad, R0.shape[1],
                                 jnp.float64),
        steps=jnp.zeros((), jnp.int32), stagnated=jnp.zeros((), bool),
        CX=out[6] if with_cx else None)


@pytest.mark.parametrize("case,use_armijo", [
    ("mucond", True), ("mucond_native", True), ("relaxed_ineq_sparse", True),
    ("relaxed_ineq_dense", True), ("relaxed_lifted_sparse", False),
])
def test_inner_step_matches_on_each_branch(case, use_armijo):
    """One inner step (and three more from the carried state) on each
    branch: Armijo or exact line search, carried CX or dense C."""
    dp_j, dp_t, R0, lam = setup_case(case)
    k = 4
    use_cx = fast_diag_eligible(dp_t)
    cj = _j_carry(dp_j, R0, lam, k, use_cx)
    ct = convert.inner_carry_from_numpy(_fields(cj), F64, "cpu")
    assert (ct.CX is None) == (not use_cx)
    for _ in range(4):
        cj = j_inner.inner_step(dp_j, cj, _j(lam), _j(2.0), _j(0.0), k=k,
                                use_armijo=use_armijo, gtol_relative=True,
                                lbfgs_compact=True, use_cx=use_cx)
        ct = t_inner.inner_step(dp_t, ct, _t(lam), _t(2.0), 0.0, k=k,
                                use_armijo=use_armijo, gtol_relative=True,
                                lbfgs_compact=True, use_cx=use_cx)
        for name in ("R", "G", "vio_raw", "y_full", "L_val", "grad_norm"):
            _close(getattr(ct, name), getattr(cj, name), rtol=1e-9,
                   atol=1e-12, what=name)
        if use_cx:
            _close(ct.CX, cj.CX, rtol=1e-9, atol=1e-12)
        assert ct.stagnated == bool(cj.stagnated)
        _close(ct.lbfgs.rho, cj.lbfgs.rho, rtol=1e-9)


@pytest.mark.parametrize("case", ["mucond", "relaxed_ineq_dense"])
def test_inner_chunk_matches(case):
    dp_j, dp_t, R0, lam = setup_case(case)
    k, r = 4, R0.shape[1]
    L0, vio0, G0, y0, gn0, _ = j_al_value_grad(dp_j, _j(R0), _j(lam),
                                               _j(2.0), True, True)
    cj, vnj = j_inner.inner_chunk(
        dp_j, _j(R0), G0, y0, vio0, L0, gn0,
        j_lbfgs.lbfgs_init(k, dp_j.n_pad, r, jnp.float64), _j(lam), _j(2.0),
        _j(1e-12), _j(0.0), 10, k=k, use_armijo=True, gtol_relative=True,
        ptol_relative=True)
    ct, vnt = t_inner.inner_chunk(
        dp_t, _t(R0), _t(G0), _t(y0), _t(vio0), _t(L0), _t(gn0),
        t_lbfgs.lbfgs_init(k, dp_t.n_pad, r, F64), _t(lam), _t(2.0), 1e-12,
        0.0, 10, k=k, use_armijo=True, gtol_relative=True,
        ptol_relative=True)
    assert ct.steps == int(cj.steps)
    for name in ("R", "vio_raw", "L_val", "grad_norm"):
        _close(getattr(ct, name), getattr(cj, name), rtol=1e-8, atol=1e-11,
               what=name)
    _close(vnt, vnj, rtol=1e-8)


# -------------------------------------------------------- the dual bound


def test_ls_dual_head_with_the_carried_cx_matches():
    # unscaled R: a d-centred one has dᵀR ≈ 1e-16, and the low-rank
    # multiplier's normal equations are then rounding noise
    dp_j, dp_t, R0, lam = setup_case("mucond", scale=0)
    assert dp_t.ls_eligible and dp_j.ls_eligible
    y_fb = -lam
    CR_j = j_spmm_C(dp_j, _j(R0))
    want = j_dualbound.ls_dual_head(dp_j, _j(R0), CR_j, y_fallback=_j(y_fb))
    got = t_dualbound.ls_dual_head(dp_t, _t(R0), t_spmm_C(dp_t, _t(R0)),
                                   y_fallback=_t(y_fb))
    _close(got, want, atol=1e-12)


def test_dual_obj_on_the_fast_diagonal_engine_matches():
    dp_j, dp_t, R0, lam = setup_case("mucond")
    _, vio, _, _, _, _ = j_al_value_grad(dp_j, _j(R0), _j(lam), _j(2.0),
                                         True, True)
    key = jax.random.PRNGKey(3)
    v0 = j_lanczos._lanczos_v0(dp_j, key, jnp.float64)
    want = j_dualbound.dual_obj(dp_j, _j(lam), _j(2.0), vio, 6.0, 500, key)
    got = t_dualbound.dual_obj(dp_t, _t(lam), _t(2.0), _t(vio), 6.0, 500,
                               None, v0=_t(v0))
    _close(got[0], want[0], rtol=1e-9)
    _close(got[2], want[2])


# ----------------------------------------------------------- major chunk


KW = dict(k=4, use_armijo=True, gtol_relative=True, ptol_relative=True,
          objtol_relative=True, q_max=64, highprecision=False)


@pytest.mark.parametrize("case", ["mucond", "relaxed_ineq_dense"])
def test_major_chunk_matches_before_the_first_strict_boundary(case):
    """Inner steps, σ updates and the re-sync (with the CX refresh on the
    fast-diagonal engine) through the Armijo path."""
    # R at 1.5× the feasible scale: every boundary of the budget is
    # infeasible, so no Lanczos start vector is drawn
    dp_j, dp_t, R0, lam = setup_case(case, scale=1.5)
    k, r = 4, R0.shape[1]
    with_cx = fast_diag_eligible(dp_t)
    cj = j_major.init_major_carry(
        dp_j, _j(R0), _j(lam), 2.0, 0.5, 0.5, jax.random.PRNGKey(0),
        j_lbfgs.lbfgs_init(k, dp_j.n_pad, r, jnp.float64), 4,
        gtol_relative=True, ptol_relative=True, with_cx=with_cx)
    ct = t_major.init_major_carry(
        dp_t, _t(R0), _t(lam), 2.0, 0.5, 0.5, torch.Generator(),
        t_lbfgs.lbfgs_init(k, dp_t.n_pad, r, F64), 4, gtol_relative=True,
        ptol_relative=True, with_cx=with_cx)
    assert (ct.ic.CX is None) == (not with_cx)
    # ptol 1e-9 keeps every boundary of this budget loose (no dual bound)
    stag = 1e8 * np.finfo(np.float64).eps
    args = (40, 10 ** 5, 0, stag, 1e-9, 8 * np.finfo(float).eps, 1e-2, 2.0,
            6.0, 4)
    jargs = [jnp.asarray(a, jnp.int32) if isinstance(a, int)
             else jnp.asarray(a, jnp.float64) for a in args]
    cj, vj = j_major.major_chunk(dp_j, cj, *jargs, 0, **KW)
    ct, vt = t_major.major_chunk(dp_t, ct, *args, None, **KW)
    assert int(cj.feas_count) == 0 and int(cj.majoriters) >= 1
    assert ct.majoriters == int(cj.majoriters)
    assert ct.ic.steps == int(cj.ic.steps)
    # 25 steps on μ-conductance amplify float64 rounding ~1e6-fold (the
    # ddᵀ term makes the AL stiff), hence 1e-6
    for name in ("lam", "sigma", "cur_ptol", "cur_gtol"):
        _close(getattr(ct, name), getattr(cj, name), rtol=1e-6, what=name)
    for name in ("R", "vio_raw", "L_val", "grad_norm"):
        _close(getattr(ct.ic, name), getattr(cj.ic, name), rtol=1e-6,
               atol=1e-9, what=name)
    if with_cx:
        _close(ct.ic.CX, cj.ic.CX, rtol=1e-6, atol=1e-7)   # ‖C‖ ≈ 30
    _close(vt, vj, rtol=1e-6)


# ------------------------------------------------------------ eligibility


@pytest.mark.parametrize("case,eligible", [
    ("mucond", True), ("mucond_native", True), ("relaxed_ineq_sparse", True),
    ("relaxed_ineq_dense", True), ("relaxed_lifted_sparse", False),
])
def test_k2_eligibility_matches(case, eligible):
    """K2 takes the all-diagonal inequality families; the lifted relaxed
    MaxCut has two entries per narrow constraint and takes neither kernel
    (as in the JAX package)."""
    from sdplrplus_tpu.ops.megakernel import megakernel_eligible

    dp_j, dp_t, _, _ = setup_case(case)
    use_armijo = dp_t.has_inequalities
    assert mk.megakernel_eligible(dp_t, 4, 4, use_armijo, F64) == eligible
    assert megakernel_eligible(dp_j, 4, 4, use_armijo, jnp.float64) \
        == eligible
    assert not mk.megakernel_eligible(dp_t, mk.MAX_RP + 1, 4, use_armijo, F64)
