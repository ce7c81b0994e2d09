"""Each module of the PyTorch port against its JAX counterpart.

The same inputs, made from a seed with numpy, go through the JAX
function and the port's function, in float64 on the CPU; the results
agree to rtol 1e-10 unless a test says otherwise. State moves from the
JAX package into the port through ``sdplrplus_tpu_torch.convert``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdplrplus_tpu.compile import compile_problem as j_compile
from sdplrplus_tpu.models import problems as j_models
from sdplrplus_tpu.ops import cubic as j_cubic
from sdplrplus_tpu.ops import lanczos as j_lanczos
from sdplrplus_tpu.ops.device import to_device as j_to_device
from sdplrplus_tpu.problem import SDPProblem as JProblem
from sdplrplus_tpu.solver import dualbound as j_dualbound
from sdplrplus_tpu.solver import lbfgs as j_lbfgs
from sdplrplus_tpu.solver import major as j_major
from sdplrplus_tpu.solver.al import al_value_grad as j_al_value_grad
from sdplrplus_tpu.solver.inner import inner_chunk as j_inner_chunk
from sdplrplus_tpu.solver.linesearch import (
    exact_linesearch as j_exact_linesearch,
)

from sdplrplus_tpu_torch import convert
from sdplrplus_tpu_torch.compile import compile_problem as t_compile
from sdplrplus_tpu_torch.models import problems as t_models
from sdplrplus_tpu_torch.ops import cubic as t_cubic
from sdplrplus_tpu_torch.ops import lanczos as t_lanczos
from sdplrplus_tpu_torch.ops.device import (
    FLOAT_FIELDS, INT_FIELDS, STATIC_FIELDS, to_device as t_to_device,
)
from sdplrplus_tpu_torch.problem import SDPProblem as TProblem
from sdplrplus_tpu_torch.solver import dualbound as t_dualbound
from sdplrplus_tpu_torch.solver import lbfgs as t_lbfgs
from sdplrplus_tpu_torch.solver import major as t_major
from sdplrplus_tpu_torch.solver.al import al_value_grad as t_al_value_grad
from sdplrplus_tpu_torch.solver.inner import inner_chunk as t_inner_chunk
from sdplrplus_tpu_torch.solver.linesearch import (
    exact_linesearch as t_exact_linesearch,
)

F64 = torch.float64
RTOL = 1e-10
FAMILIES = {"maxcut": "maxcut", "minbis": "minimum_bisection",
            "cutnorm": "cutnorm"}


def _problems(problem, n=24, p=0.5, seed=0, dense=True):
    A = j_models.make_random_graph(n, p, seed=seed)
    gen = FAMILIES[problem]
    Cj, Asj, bj = getattr(j_models, gen)(A)
    Ct, Ast, bt = getattr(t_models, gen)(A)
    cp_j = j_compile(JProblem(Cj, Asj, np.asarray(bj, np.float64), None),
                     dense=dense)
    cp_t = t_compile(TProblem(Ct, Ast, np.asarray(bt, np.float64), None),
                     dense=dense)
    return cp_j, cp_t


def _setup(problem="maxcut", n=24, p=0.5, r=3, seed=0):
    cp_j, cp_t = _problems(problem, n, p, seed)
    dp_j = j_to_device(cp_j, jnp.float64)
    dp_t = t_to_device(cp_t, F64, "cpu")
    rng = np.random.default_rng(seed + 1)
    R0 = np.zeros((dp_j.n_pad, r))
    R0[: dp_j.n] = rng.uniform(-1, 1, (dp_j.n, r))
    lam = rng.standard_normal(dp_j.m) * 0.1
    return dp_j, dp_t, R0, lam


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _close(got, want, rtol=RTOL, atol=0.0, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _fields(obj):
    """A JAX object as the nested host dict ``convert`` takes."""
    if hasattr(obj, "_asdict"):
        items = obj._asdict().items()
    else:
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    out = {}
    for name, v in items:
        if hasattr(v, "_asdict") or dataclasses.is_dataclass(v):
            out[name] = _fields(v)
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            out[name] = [_fields(t) for t in v]
        elif isinstance(v, jax.Array):
            out[name] = np.asarray(v)
        else:
            out[name] = v
    return out


# ---------------------------------------------------------------- compile

@pytest.mark.parametrize("problem", sorted(FAMILIES))
@pytest.mark.parametrize("dense", [True, False])
def test_compile_problem_fields_equal(problem, dense):
    cp_j, cp_t = _problems(problem, dense=dense)
    for f in dataclasses.fields(cp_j):
        a, b = getattr(cp_j, f.name), getattr(cp_t, f.name)
        if f.name == "lowrank":
            assert len(a) == len(b)
            for ta, tb in zip(a, b):
                assert ta.gid == tb.gid
                np.testing.assert_array_equal(ta.B, tb.B)
                np.testing.assert_array_equal(ta.d, tb.d)
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


# ----------------------------------------------------------------- device

@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_to_device_and_convert_equal_the_jax_arrays(problem):
    dp_j, dp_t, _, _ = _setup(problem)
    dp_c = convert.device_problem_from_numpy(_fields(dp_j), F64, "cpu")
    for f in FLOAT_FIELDS + INT_FIELDS:
        a = getattr(dp_j, f)
        for dp in (dp_t, dp_c):
            b = getattr(dp, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(dp_t, f) == getattr(dp_j, f) == getattr(dp_c, f), f
    assert len(dp_t.lowrank) == len(dp_j.lowrank) == len(dp_c.lowrank)
    for tj, tt, tc in zip(dp_j.lowrank, dp_t.lowrank, dp_c.lowrank):
        assert tj.gid == tt.gid == tc.gid
        for dp_l in (tt, tc):
            np.testing.assert_array_equal(dp_l.B.numpy(), np.asarray(tj.B))
            np.testing.assert_array_equal(dp_l.d.numpy(), np.asarray(tj.d))


# ------------------------------------------------------ AL and line search

@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_al_value_grad_matches(problem):
    dp_j, dp_t, R0, lam = _setup(problem)
    want = j_al_value_grad(dp_j, jnp.asarray(R0), jnp.asarray(lam),
                           jnp.asarray(2.0), True, True)
    got = t_al_value_grad(dp_t, _t(R0), _t(lam), _t(2.0), True, True)
    for g, w, name in zip(got, want, ("L", "vio_raw", "G", "y_full",
                                       "grad_norm", "vio_norm")):
        _close(g, w, what=name)


@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_exact_linesearch_matches(problem):
    dp_j, dp_t, R0, lam = _setup(problem)
    _, vio, G, _, _, _ = j_al_value_grad(
        dp_j, jnp.asarray(R0), jnp.asarray(lam), jnp.asarray(2.0), True, True)
    D = -np.asarray(G)
    want = j_exact_linesearch(dp_j, jnp.asarray(R0), jnp.asarray(D), vio,
                              jnp.asarray(lam), jnp.asarray(2.0))
    got = t_exact_linesearch(dp_t, _t(R0), _t(D), _t(vio), _t(lam), _t(2.0))
    for g, w, name in zip(got, want, ("alpha", "L", "vio_raw")):
        _close(g, w, what=name)


# ------------------------------------------------------------------ L-BFGS

def _lbfgs_pair(k=4, n_pad=16, r=3, pushes=6, seed=3):
    rng = np.random.default_rng(seed)
    sj = j_lbfgs.lbfgs_init(k, n_pad, r, jnp.float64)
    st = t_lbfgs.lbfgs_init(k, n_pad, r, F64)
    G = rng.standard_normal((n_pad, r))
    for _ in range(pushes):
        D = rng.standard_normal((n_pad, r))
        G_new = G + 0.3 * D + 0.05 * rng.standard_normal((n_pad, r))
        alpha = float(rng.uniform(0.2, 1.0))
        sj = j_lbfgs.lbfgs_push(sj, jnp.asarray(alpha), jnp.asarray(D),
                                jnp.asarray(G), jnp.asarray(G_new), k)
        st = t_lbfgs.lbfgs_push(st, _t(alpha), _t(D), _t(G), _t(G_new), k)
        G = G_new
    return sj, st, G


@pytest.mark.parametrize("pushes", [2, 6])
@pytest.mark.parametrize("compact", [True, False])
def test_lbfgs_direction_and_push_match(compact, pushes):
    k = 4
    sj, st, G = _lbfgs_pair(k=k, pushes=pushes)
    for name in ("s_hist", "y_hist", "rho", "sty", "yty"):
        _close(getattr(st, name), getattr(sj, name), what=name)
    assert st.head == int(sj.head)
    want = j_lbfgs.lbfgs_direction(sj, jnp.asarray(G), k, compact=compact)
    got = t_lbfgs.lbfgs_direction(st, _t(G), k, compact=compact)
    _close(got, want, rtol=1e-9, atol=1e-12)
    # both forms are one operator
    other = t_lbfgs.lbfgs_direction(st, _t(G), k, compact=not compact)
    _close(got, other.numpy(), rtol=1e-8, atol=1e-10)


def test_lbfgs_clear_and_k0():
    _, st, G = _lbfgs_pair()
    cleared = t_lbfgs.lbfgs_clear(st)
    assert cleared.head == 0 and float(cleared.rho.abs().sum()) == 0.0
    _close(t_lbfgs.lbfgs_direction(cleared, _t(G), 4), -G)
    _close(t_lbfgs.lbfgs_direction(st, _t(G), 0), -G)


# --------------------------------------------------------- the quartic

QUARTICS = [
    (1.0, -2.0, 1.0, 0.5, 0.25),        # convex, interior minimum
    (0.0, -1.0, 0.5, 0.0, 0.0),         # pure quadratic
    (0.0, -1.0, 0.0, 0.0, 0.0),         # linear: the far endpoint
    (0.0, 1.0, 0.0, 0.0, 0.0),          # increasing: zero step
    (0.0, 0.0, 0.0, 0.0, 0.0),          # flat
    (0.0, -3.0, 1.0, 2.0, -1.0),        # negative leading coefficient
    (0.0, -0.1, 3.0, -7.0, 4.0),        # three real stationary points
    (2.0, -4e13, 1e13, 3e12, 5e12),     # badly scaled (f32 overflow guard)
    (0.0, -1e-9, 1e-6, 0.0, 1e-3),      # tiny coefficients
    (0.0, -1.0, 1.0, 1e-18, 1e-20),     # near-degenerate cubic term
]


@pytest.mark.parametrize("coeffs", QUARTICS)
def test_minimize_quartic_matches(coeffs):
    ja = tuple(jnp.asarray(c, jnp.float64) for c in coeffs)
    ta = tuple(_t(c) for c in coeffs)
    for amax in (1.0, 10.0):
        aj, fj = j_cubic.minimize_quartic(ja, jnp.asarray(amax))
        at, ft = t_cubic.minimize_quartic(ta, amax)
        _close(at, aj, rtol=1e-9, atol=1e-14)
        _close(ft, fj, rtol=1e-9, atol=1e-12)
    e, d, c, b, a = coeffs
    rj = j_cubic.cubic_real_roots(*[jnp.asarray(x, jnp.float64)
                                    for x in (4 * a, 3 * b, 2 * c, d)])
    rt = t_cubic.cubic_real_roots(*[_t(x) for x in (4 * a, 3 * b, 2 * c, d)])
    np.testing.assert_array_equal(np.isnan(rt.numpy()), np.isnan(rj))
    ok = ~np.isnan(np.asarray(rj))
    _close(rt.numpy()[ok], np.asarray(rj)[ok], rtol=1e-8, atol=1e-12)


# -------------------------------------------------------------- inner loop

@pytest.mark.parametrize("problem", ["maxcut", "minbis"])
@pytest.mark.parametrize("compact", [True, False])
def test_inner_chunk_trajectories_match(problem, compact):
    dp_j, dp_t, R0, lam = _setup(problem)
    k, r = 4, R0.shape[1]
    sigma = 2.0
    L0, vio0, G0, y0, gn0, _ = j_al_value_grad(
        dp_j, jnp.asarray(R0), jnp.asarray(lam), jnp.asarray(sigma), True,
        True)
    for steps in (1, 25):
        cj, vnj = j_inner_chunk(
            dp_j, jnp.asarray(R0), G0, y0, vio0, L0, gn0,
            j_lbfgs.lbfgs_init(k, dp_j.n_pad, r, jnp.float64),
            jnp.asarray(lam), jnp.asarray(sigma), jnp.asarray(1e-12),
            jnp.asarray(0.0), steps, k=k, use_armijo=False,
            gtol_relative=True, ptol_relative=True, lbfgs_compact=compact)
        ct, vnt = t_inner_chunk(
            dp_t, _t(R0), _t(G0), _t(y0), _t(vio0), _t(L0), _t(gn0),
            t_lbfgs.lbfgs_init(k, dp_t.n_pad, r, F64), _t(lam), _t(sigma),
            1e-12, 0.0, steps, k=k, use_armijo=False, gtol_relative=True,
            ptol_relative=True, lbfgs_compact=compact)
        assert ct.steps == int(cj.steps) == steps
        for name in ("R", "G", "vio_raw", "y_full", "L_val", "grad_norm"):
            _close(getattr(ct, name), getattr(cj, name), atol=1e-12,
                   what=f"{name} after {steps}")
        _close(ct.lbfgs.s_hist, cj.lbfgs.s_hist, atol=1e-12)
        _close(ct.lbfgs.rho, cj.lbfgs.rho, rtol=1e-9)
        _close(vnt, vnj)


def test_inner_carry_from_numpy_round_trips():
    dp_j, dp_t, R0, lam = _setup("maxcut")
    L0, vio0, G0, y0, gn0, _ = j_al_value_grad(
        dp_j, jnp.asarray(R0), jnp.asarray(lam), jnp.asarray(2.0), True, True)
    cj, _ = j_inner_chunk(
        dp_j, jnp.asarray(R0), G0, y0, vio0, L0, gn0,
        j_lbfgs.lbfgs_init(4, dp_j.n_pad, 3, jnp.float64), jnp.asarray(lam),
        jnp.asarray(2.0), jnp.asarray(1e-12), jnp.asarray(0.0), 7, k=4,
        use_armijo=False, gtol_relative=True, ptol_relative=True)
    ct = convert.inner_carry_from_numpy(_fields(cj), F64, "cpu")
    assert ct.steps == 7 and ct.lbfgs.head == int(cj.lbfgs.head)
    for name in ("R", "G", "vio_raw", "L_val"):
        _close(getattr(ct, name), getattr(cj, name), rtol=0)
    _close(ct.lbfgs.y_hist, cj.lbfgs.y_hist, rtol=0)


# ------------------------------------------------------------------ Lanczos

@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_lanczos_and_certified_eig_match(problem):
    dp_j, dp_t, R0, lam = _setup(problem, n=40)
    _, _, _, y_full, _, _ = j_al_value_grad(
        dp_j, jnp.asarray(R0), jnp.asarray(lam), jnp.asarray(2.0), True, True)
    key = jax.random.PRNGKey(7)
    v0 = j_lanczos._lanczos_v0(dp_j, key, jnp.float64)
    # without reorthogonalization the recurrence amplifies rounding by
    # orders of magnitude per step once a Ritz value converges (MinBisection's
    # 11ᵀ term converges in two), so α and β are held entry by entry over
    # the first four steps and the eigenvalue estimates over the full space
    for q in (4, 64):
        aj, bj, kj = j_lanczos.lanczos_alpha_beta(
            dp_j, jnp.zeros((1,)), y_full, key, jnp.asarray(q, jnp.int32),
            q_max=64)
        at, bt, kt = t_lanczos.lanczos_alpha_beta_impl(
            dp_t, _t(y_full), _t(v0), q, q_max=64)
        assert int(kt) == int(kj)
        k = int(kj)
        if q == 4:
            _close(at[:k], aj[:k], rtol=1e-9, atol=1e-11)
            _close(bt[:k], bj[:k], rtol=1e-9, atol=1e-11)
            continue
        # the tridiagonal solvers on the same (α, β): equal
        tj, mj = j_lanczos.tridiag_min_eig_device_certified(aj, bj, kj)
        tt, mt = t_lanczos.tridiag_min_eig_device_certified(
            _t(aj), _t(bj), int(kj))
        _close(tt, tj, rtol=1e-10, atol=1e-12)
        _close(mt, mj, rtol=1e-6, atol=1e-12)
        rj = j_lanczos.tridiag_min_eig_resid(np.asarray(aj), np.asarray(bj),
                                             k)
        rt = t_lanczos.tridiag_min_eig_resid(_t(aj), _t(bj), k)
        _close(rt, rj, rtol=1e-10, atol=1e-12)
        _close(t_lanczos.tridiag_min_eig(_t(aj), _t(bj), k),
               j_lanczos.tridiag_min_eig(np.asarray(aj), np.asarray(bj), k),
               rtol=1e-10, atol=1e-12)
        # over the full Krylov space both runs find λ_min; the residual
        # margin is then at rounding level, ‖S‖·1e-9 at most
        tt, mt = t_lanczos.tridiag_min_eig_device_certified(at, bt, kt)
        scale = float(np.max(np.abs(np.asarray(aj[:k]))))
        _close(tt, tj, rtol=1e-9, atol=1e-11)
        assert abs(float(mt) - float(mj)) <= 1e-9 * scale
    assert t_lanczos.lanczos_q(500, 800) == j_lanczos.lanczos_q(500, 800)
    assert t_lanczos.bucket_q_max(300) == j_lanczos.bucket_q_max(300)


# ---------------------------------------------------------------- dual bound

@pytest.mark.parametrize("problem", sorted(FAMILIES))
def test_ls_dual_head_matches(problem):
    dp_j, dp_t, R0, lam = _setup(problem)
    assert dp_t.ls_eligible == dp_j.ls_eligible
    if not dp_j.ls_eligible:
        pytest.skip(f"{problem} is not least-squares eligible")
    y_fb = -lam
    want = j_dualbound.ls_dual_head(dp_j, jnp.asarray(R0),
                                    y_fallback=jnp.asarray(y_fb))
    got = t_dualbound.ls_dual_head(dp_t, _t(R0), y_fallback=_t(y_fb))
    _close(got, want, atol=1e-12)


def test_dual_obj_matches_from_the_same_start_vector():
    dp_j, dp_t, R0, lam = _setup("maxcut", n=40)
    L, vio, _, _, _, _ = j_al_value_grad(
        dp_j, jnp.asarray(R0), jnp.asarray(lam), jnp.asarray(2.0), True, True)
    key = jax.random.PRNGKey(3)
    v0 = j_lanczos._lanczos_v0(dp_j, key, jnp.float64)
    want = j_dualbound.dual_obj(dp_j, jnp.asarray(lam), jnp.asarray(2.0),
                                vio, 40.0, 500, key)
    got = t_dualbound.dual_obj(dp_t, _t(lam), _t(2.0), _t(vio), 40.0, 500,
                               None, v0=_t(v0))
    _close(got[0], want[0], rtol=1e-9)
    _close(got[1], want[1], rtol=1e-9, atol=1e-11)
    _close(got[2], want[2])


# -------------------------------------------------------------- major chunk

KW = dict(k=4, use_armijo=False, gtol_relative=True, ptol_relative=True,
          objtol_relative=True, q_max=64, highprecision=False)


def _chunk_args(budget, major_budget, ptol, objtol=1e-2, trace_bound=24.0):
    stag = 1e8 * np.finfo(np.float64).eps
    return (budget, major_budget, 0, stag, ptol, 8 * np.finfo(float).eps,
            objtol, 2.0, trace_bound, 4)


def _j_chunk(dp_j, carry, args):
    jargs = [jnp.asarray(a, jnp.int32) if isinstance(a, int)
             else jnp.asarray(a, jnp.float64) for a in args]
    return j_major.major_chunk(dp_j, carry, *jargs, 0, **KW)


def _init_both(dp_j, dp_t, R0, lam):
    k, r = 4, R0.shape[1]
    cj = j_major.init_major_carry(
        dp_j, jnp.asarray(R0), jnp.asarray(lam), 2.0, 0.5, 0.5,
        jax.random.PRNGKey(0), j_lbfgs.lbfgs_init(k, dp_j.n_pad, r,
                                                  jnp.float64), 4,
        gtol_relative=True, ptol_relative=True)
    ct = t_major.init_major_carry(
        dp_t, _t(R0), _t(lam), 2.0, 0.5, 0.5, torch.Generator(),
        t_lbfgs.lbfgs_init(k, dp_t.n_pad, r, F64), 4, gtol_relative=True,
        ptol_relative=True)
    return cj, ct


def _compare_major(ct, cj, rtol=RTOL):
    assert ct.majoriters == int(cj.majoriters)
    assert ct.ic.steps == int(cj.ic.steps)
    assert ct.feas_count == int(cj.feas_count)
    assert ct.converged == bool(cj.converged)
    assert ct.rankupd_cnt == int(cj.rankupd_cnt)
    for name in ("lam", "sigma", "cur_ptol", "cur_gtol"):
        _close(getattr(ct, name), getattr(cj, name), rtol=rtol, what=name)
    for name in ("R", "vio_raw", "L_val", "grad_norm"):
        _close(getattr(ct.ic, name), getattr(cj.ic, name), rtol=rtol,
               atol=1e-12, what=name)


def test_major_chunk_matches_before_the_first_strict_boundary():
    dp_j, dp_t, R0, lam = _setup("maxcut")
    cj, ct = _init_both(dp_j, dp_t, R0, lam)
    _compare_major(ct, cj)
    # ptol 1e-9 keeps every boundary of this budget loose (no dual bound)
    args = _chunk_args(budget=80, major_budget=10 ** 5, ptol=1e-9)
    cj, vj = _j_chunk(dp_j, cj, args)
    ct, vt = t_major.major_chunk(dp_t, ct, *args, None, **KW)
    assert int(cj.feas_count) == 0 and int(cj.majoriters) >= 2
    _compare_major(ct, cj)
    _close(vt, vj)


def test_major_chunk_dual_agrees_across_a_strict_boundary():
    dp_j, dp_t, R0, lam = _setup("maxcut")
    cj, _ = _init_both(dp_j, dp_t, R0, lam)
    args = _chunk_args(budget=10 ** 4, major_budget=1, ptol=1e-2,
                       objtol=1e-6)
    for _ in range(60):
        cj_next, _ = _j_chunk(dp_j, cj, args[:1] + (int(cj.majoriters) + 1,)
                              + args[2:])
        if int(cj_next.feas_count) > 0:
            break
        cj = cj_next
    assert int(cj_next.feas_count) == 1
    # the same carry in the port, and the Lanczos start vector that the
    # JAX state machine draws at its next feasible boundary
    ct = convert.major_carry_from_numpy(_fields(cj), F64, "cpu")
    sub = jax.random.split(cj.key)[1]
    v0 = j_lanczos._lanczos_v0(dp_j, sub, jnp.float64)
    ct_next, _ = t_major.major_chunk(
        dp_t, ct, args[0], ct.majoriters + 1, *args[2:], None,
        lanczos_v0=_t(v0), **KW)
    assert ct_next.feas_count == 1
    rel = abs(float(ct_next.max_dual) - float(cj_next.max_dual)) \
        / abs(float(cj_next.max_dual))
    assert rel < 1e-6
    _close(ct_next.best_lam, cj_next.best_lam, rtol=1e-6, atol=1e-9)
    _close(ct_next.last_gap, cj_next.last_gap, rtol=1e-6, atol=1e-9)
