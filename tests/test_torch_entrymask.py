"""The entry-mask engine of the port (ops/entrymask.py,
solver/inner_entry.py) and the general 𝒜(UUᵀ) and S·X that its carries
need (ops/forward.py, ops/adjoint.py), each against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX
function and the port's, in float64 on the CPU. Tolerances, stated per
test: operators and one line search agree to 1e-10 (relative, with an
absolute floor of 1e-12 for entries that cancel to 0); 25 steps of the
entry inner loop to 1e-8, as the JAX package holds its own entry loop
against its general one (tests/test_entrymask.py); the split/merge round
trip is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sdplrplus_tpu.compile import compile_problem as j_compile
from sdplrplus_tpu.models import problems as j_models
from sdplrplus_tpu.ops import adjoint as j_adjoint
from sdplrplus_tpu.ops import entrymask as j_em
from sdplrplus_tpu.ops import forward as j_forward
from sdplrplus_tpu.ops import lanczos as j_lanczos
from sdplrplus_tpu.ops.device import to_device as j_to_device
from sdplrplus_tpu.problem import SDPProblem as JProblem
from sdplrplus_tpu.solver import dualbound as j_dualbound
from sdplrplus_tpu.solver.al import al_value_grad as j_al_value_grad
from sdplrplus_tpu.solver.inner_entry import entry_chunk as j_entry_chunk
from sdplrplus_tpu.solver.lbfgs import lbfgs_init as j_lbfgs_init

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.compile import compile_problem as t_compile
from sdplrplus_tpu_torch.models import problems as t_models
from sdplrplus_tpu_torch.ops import adjoint as t_adjoint
from sdplrplus_tpu_torch.ops import blocklanczos as t_block
from sdplrplus_tpu_torch.ops import entrymask as t_em
from sdplrplus_tpu_torch.ops import forward as t_forward
from sdplrplus_tpu_torch.ops import lanczos as t_lanczos
from sdplrplus_tpu_torch.ops.device import to_device as t_to_device
from sdplrplus_tpu_torch.problem import SDPProblem as TProblem
from sdplrplus_tpu_torch.solver import dualbound as t_dualbound
from sdplrplus_tpu_torch.solver.al import al_value_grad as t_al_value_grad
from sdplrplus_tpu_torch.solver.inner_entry import (
    entry_chunk as t_entry_chunk,
)
from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init as t_lbfgs_init
from sdplrplus_tpu_torch.solver.outer import ENGINE_ENTRY

from oracles import dense_primal_vio, dense_S

F64 = torch.float64
RTOL = 1e-10
GENS = ("lovasz_theta", "minimum_bisection")


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _close(got, want, rtol=RTOL, atol=1e-12):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _pair(gen="lovasz_theta", n=12, p=0.5, seed=3, entry=True):
    """(JAX DeviceProblem, port DeviceProblem, the JAX package's
    SDPProblem for tests/oracles.py) of one instance, compiled by each package in entry mode (entry=True) or
    on the general path (entry=False), dense mode off."""
    A = j_models.make_random_graph(n, p, seed=seed)
    Cj, Asj, bj = getattr(j_models, gen)(A)
    Ct, Ast, bt = getattr(t_models, gen)(A)
    cp_j = j_compile(JProblem(Cj, Asj, np.asarray(bj, np.float64), None),
                     entry=entry, dense=False)
    cp_t = t_compile(TProblem(Ct, Ast, np.asarray(bt, np.float64), None),
                     entry=entry, dense=False)
    return (j_to_device(cp_j, jnp.float64), t_to_device(cp_t, F64, "cpu"),
            JProblem(Cj, Asj, np.asarray(bj, np.float64), None))


def _factor(dp, r, seed):
    rng = np.random.default_rng(seed)
    R = np.zeros((dp.n_pad, r))
    R[: dp.n] = rng.normal(size=(dp.n, r))
    return R


# ---------------------------------------------------------------- selection

def test_entry_auto_selected_for_lovasz_theta():
    A = j_models.make_random_graph(12, 0.5, seed=3)
    cp = t_compile(TProblem(*t_models.lovasz_theta(A), None))
    assert cp.ew_c2 is not None and cp.C_dense is None
    cp = t_compile(TProblem(*t_models.maxcut(A), None))
    assert cp.ew_c2 is None  # dense mode covers the diagonal families


def test_split_merge_roundtrip_is_exact():
    """entry_split then entry_merge gives back every slot bit for bit:
    _scatter_sym's mirror must not double a diagonal entry (MinBisection
    has none in entry mode; θ's K₁ self-loops would)."""
    for gen in GENS:
        _, dp, _ = _pair(gen)
        vio = _t(np.random.default_rng(0).normal(size=dp.m + 1))
        v_ew, v_ex, obj = t_em.entry_split(dp, vio)
        assert torch.equal(t_em.entry_merge(dp, v_ew, v_ex, obj), vio)
        # the mask is symmetric and its support is the entry positions
        assert torch.equal(v_ew, v_ew.T)
        assert int((v_ew != 0).sum()) <= int((dp.ew_h != 0).sum())


def test_scatter_sym_counts_a_diagonal_entry_once():
    _, dp, _ = _pair()
    rows, cols = dp.entry_rows.clone(), dp.entry_cols.clone()
    cols[0] = rows[0]   # make the first entry diagonal
    dp2 = dataclasses.replace(dp, entry_cols=cols)
    vals = _t(np.arange(1, rows.numel() + 1, dtype=float))
    M = t_em._scatter_sym(dp2, torch.zeros_like(dp.ew_c2), vals)
    assert float(M[rows[0], rows[0]]) == 1.0
    assert float(M.sum()) == 2 * float(vals.sum()) - 1.0


# ------------------------------------------- the general A_uu and apply_S

@pytest.mark.parametrize("seed", [5, 6])
def test_general_A_uu_matches_jax_and_the_dense_oracle(seed):
    """θ's rows: off-diagonal constraint entries (every diagonal family
    takes the diagonal forms)."""
    dp_j, dp_t, prob = _pair(n=14, seed=seed, entry=False)
    assert t_forward.is_general(dp_t)
    R = _factor(dp_j, 3, 1)
    got = t_forward.A_uu(dp_t, _t(R))
    _close(got, j_forward.A_uu(dp_j, jnp.asarray(R)))
    # against the dense oracle: ⟨Aᵢ, RRᵀ⟩ (slot m is ⟨C, RRᵀ⟩, b added back)
    want = dense_primal_vio(prob, R[: prob.n])
    want[: prob.m] += prob.b
    _close(got, want, rtol=1e-9, atol=1e-10)
    # uv_values_uu: one gather over the pattern's rows then columns
    uv = t_forward.uv_values_uu(dp_t, _t(R))
    _close(uv, j_forward.uv_values_uu(dp_j, jnp.asarray(R)))


@pytest.mark.parametrize("seed", [5, 6])
def test_general_apply_S_matches_jax_and_the_dense_oracle(seed):
    dp_j, dp_t, prob = _pair(n=14, seed=seed, entry=False)
    assert t_forward.is_general(dp_t)
    rng = np.random.default_rng(2)
    y_full = rng.normal(size=dp_j.m + 1)
    X = _factor(dp_j, 2, 3)
    s_tri_j = j_adjoint.assemble_s_tri(dp_j, jnp.asarray(y_full))
    s_tri_t = t_adjoint.assemble_s_tri(dp_t, _t(y_full))
    _close(s_tri_t, s_tri_j)
    want = j_adjoint.apply_S(dp_j, s_tri_j, jnp.asarray(y_full),
                             jnp.asarray(X))
    _close(t_adjoint.apply_S(dp_t, _t(y_full), _t(X)), want)
    _close(t_adjoint.apply_S(dp_t, _t(y_full), _t(X), s_tri_t), want)
    S = dense_S(prob, y_full)
    _close(t_adjoint.apply_S(dp_t, _t(y_full), _t(X))[: prob.n],
           S @ X[: prob.n], rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("gen", GENS)
def test_al_value_grad_on_the_general_path_matches_jax(gen):
    """The carry build of the entry engine: fg! through the general A_uu
    and apply_S, on the entry-mode problem itself."""
    dp_j, dp_t, _ = _pair(gen, n=14, seed=5)
    R = _factor(dp_j, 3, 4)
    lam = np.random.default_rng(5).normal(size=dp_j.m)
    out_j = j_al_value_grad(dp_j, jnp.asarray(R), jnp.asarray(lam),
                            jnp.asarray(2.5), True, True)
    out_t = t_al_value_grad(dp_t, _t(R), _t(lam), _t(2.5), True, True)
    for a, b in zip(out_t, out_j):
        _close(a, b)


def test_general_inner_engine_still_raises_slice_e():
    """The general inner engine (ROADMAP slice E) is ported: A_uv and
    A_linesearch on the same instance outside entry mode agree with the
    JAX package's (tests/test_torch_general.py holds the rest)."""
    dp_j, dp_t, _ = _pair(entry=False)
    R, D = _factor(dp_t, 2, 0), _factor(dp_t, 2, 1)
    _close(t_forward.A_uv(dp_t, _t(R), _t(D)),
           j_forward.A_uv(dp_j, jnp.asarray(R), jnp.asarray(D)))
    for got, want in zip(t_forward.A_linesearch(dp_t, _t(R), _t(D)),
                         j_forward.A_linesearch(dp_j, jnp.asarray(R),
                                                jnp.asarray(D))):
        _close(got, want)


# --------------------------------------------------------- entry operators

def _entry_state(gen, seed=1, r=3, sigma=2.7):
    dp_j, dp_t, _ = _pair(gen)
    R = _factor(dp_j, r, seed)
    lam = np.random.default_rng(seed + 10).normal(size=dp_j.m)
    _, vio_j, G_j, _, _, _ = j_al_value_grad(
        dp_j, jnp.asarray(R), jnp.asarray(lam), jnp.asarray(sigma),
        gtol_relative=False, ptol_relative=False)
    return dp_j, dp_t, R, lam, sigma, np.asarray(vio_j), np.asarray(G_j)


@pytest.mark.parametrize("gen", GENS)
def test_gradient_entry_matches_jax_and_the_general_gradient(gen):
    dp_j, dp_t, R, lam, sigma, vio, G_ref = _entry_state(gen)
    v_ew, v_ex, obj = t_em.entry_split(dp_t, _t(vio))
    Lam_ew, lam_ex = t_em.entry_lam(dp_t, _t(lam))
    CR = t_em.apply_C_entry(dp_t, _t(R))
    G = t_em.gradient_entry(dp_t, _t(R), CR, v_ew, v_ex, Lam_ew, lam_ex,
                            _t(sigma))
    jv = j_em.entry_split(dp_j, jnp.asarray(vio))
    jl = j_em.entry_lam(dp_j, jnp.asarray(lam))
    jCR = j_em.apply_C_entry(dp_j, jnp.asarray(R))
    _close(CR, jCR)
    G_j = j_em.gradient_entry(dp_j, jnp.asarray(R), jCR, jv[0], jv[1],
                              jl[0], jl[1], jnp.asarray(sigma))
    _close(G, G_j)
    # the port's own general gradient, and the JAX package's
    _, _, G_gen, _, _, _ = t_al_value_grad(dp_t, _t(R), _t(lam), _t(sigma),
                                           False, False)
    _close(G, G_gen, rtol=1e-10, atol=1e-10)
    _close(G, G_ref, rtol=1e-10, atol=1e-10)
    vn = t_em.vio_norm_entry(dp_t, v_ew, v_ex, 1.0)
    _close(vn, np.linalg.norm(vio[: dp_t.m]))


@pytest.mark.parametrize("gen", GENS)
def test_linesearch_entry_matches_jax(gen):
    dp_j, dp_t, R, lam, sigma, vio, G_ref = _entry_state(gen, seed=2,
                                                         sigma=3.1)
    D = -G_ref        # a descent direction: the quartic has a minimizer
    v_ew, v_ex, obj = t_em.entry_split(dp_t, _t(vio))
    Lam_ew, lam_ex = t_em.entry_lam(dp_t, _t(lam))
    ls = t_em.linesearch_entry(dp_t, _t(R), _t(D), v_ew, v_ex, obj, Lam_ew,
                               lam_ex, _t(sigma))
    jv = j_em.entry_split(dp_j, jnp.asarray(vio))
    jl = j_em.entry_lam(dp_j, jnp.asarray(lam))
    lj = j_em.linesearch_entry(dp_j, jnp.asarray(R), jnp.asarray(D), *jv,
                               *jl, jnp.asarray(sigma))
    assert 0.0 < float(ls.alpha) <= 1.0
    for name in ("alpha", "L_new", "v_ew", "v_ex", "obj", "CD"):
        _close(getattr(ls, name), getattr(lj, name))
    # the committed violations are those of the general A_uu at R + αD
    R2 = _t(R) + ls.alpha * _t(D)
    want = t_forward.A_uu(_pair(gen, entry=False)[1], R2)
    want[: dp_t.m] -= dp_t.b
    _close(t_em.entry_merge(dp_t, ls.v_ew, ls.v_ex, ls.obj), want,
           rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("gen", GENS)
def test_assemble_S_dense_matches_jax_and_the_general_apply_S(gen):
    dp_j, dp_t, _ = _pair(gen, n=11, seed=9)
    rng = np.random.default_rng(11)
    y_full = rng.normal(size=dp_j.m + 1)
    X = _factor(dp_j, 2, 12)
    S = t_em.assemble_S_dense(dp_t, _t(y_full))
    _close(S, j_em.assemble_S_dense(dp_j, jnp.asarray(y_full)))
    assert torch.equal(S, S.T)
    _close(S @ _t(X), t_adjoint.apply_S(dp_t, _t(y_full), _t(X)),
           rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("gen", GENS)
def test_ls_dual_entry_matches_jax(gen):
    dp_j, dp_t, _ = _pair(gen, n=14, seed=5)
    R = _factor(dp_j, 3, 6)
    # over the first steps the two CG recurrences agree to rounding (1e-10
    # of the largest entry). The least-squares problem is underdetermined
    # (more edge multipliers than n·r equations here), so later CG steps
    # drift along its null space on rounding noise and the two multipliers
    # part (a seeded check: 4e-14 at 5 steps, 1e-8 at 10, 4e-2 at 15); at
    # the default 25 steps both are held to what the multiplier is for,
    # the least-squares residual ‖S(y)·R‖_F, to 1e-8 of ‖C·R‖_F
    for n_cg in (2, 5):
        y_t = t_em.ls_dual_entry(dp_t, _t(R), n_cg=n_cg)
        y_j = j_em.ls_dual_entry(dp_j, jnp.asarray(R), n_cg=n_cg)
        scale = float(np.max(np.abs(np.asarray(y_j))))
        _close(y_t, y_j, rtol=0, atol=1e-10 * scale)

    def resid(y):
        y_full = torch.cat([y, torch.ones(1, dtype=F64)])
        return float(torch.linalg.norm(
            t_em.assemble_S_dense(dp_t, y_full) @ _t(R)))

    cr = float(torch.linalg.norm(t_em.apply_C_entry(dp_t, _t(R))))
    r_t = resid(t_em.ls_dual_entry(dp_t, _t(R)))
    r_j = resid(_t(j_em.ls_dual_entry(dp_j, jnp.asarray(R))))
    assert abs(r_t - r_j) <= 1e-8 * cr
    assert r_t <= resid(t_em.ls_dual_entry(dp_t, _t(R), n_cg=5)) < cr


def test_entry_chunk_trajectory_matches_jax():
    """25 steps of the entry inner loop from the same state, to 1e-8."""
    dp_j, dp_t, _ = _pair(n=14, p=0.45, seed=5)
    R = _factor(dp_j, 3, 4)
    r, k = 3, 4
    lam = np.zeros(dp_j.m)
    L, vio, G, _, gnorm, _ = j_al_value_grad(
        dp_j, jnp.asarray(R), jnp.asarray(lam), 2.0, True, True)
    got, vn = t_entry_chunk(
        dp_t, _t(R), _t(G), _t(vio), _t(L), _t(gnorm),
        t_lbfgs_init(k, dp_t.n_pad, r, F64), _t(lam), _t(2.0), 1e-30, 0.0,
        25, k=k, gtol_relative=True, ptol_relative=True)
    ref, vn_ref = j_entry_chunk(
        dp_j, jnp.asarray(R), G, vio, L, gnorm,
        j_lbfgs_init(k, dp_j.n_pad, r, jnp.float64), jnp.asarray(lam), 2.0,
        1e-30, 0.0, 25, k=k, gtol_relative=True, ptol_relative=True)
    assert got.steps == int(ref.steps) == 25
    _close(got.R, ref.R, rtol=1e-8, atol=1e-8)
    _close(got.L_val, ref.L_val, rtol=1e-8)
    _close(got.vio_raw, ref.vio_raw, rtol=1e-8, atol=1e-8)
    _close(got.y_full, ref.y_full, rtol=1e-8, atol=1e-8)
    _close(vn, vn_ref, rtol=1e-8)


# --------------------------------------------------- Lanczos on dense S

def test_lanczos_on_S_dense_matches_jax():
    dp_j, dp_t, _ = _pair(n=40, p=0.3, seed=2)
    y_full = np.random.default_rng(3).normal(size=dp_j.m + 1)
    S_j = j_em.assemble_S_dense(dp_j, jnp.asarray(y_full))
    key = jax.random.PRNGKey(5)
    v0 = j_lanczos._lanczos_v0(dp_j, key, jnp.float64)
    aj, bj, kj = j_lanczos.lanczos_alpha_beta(
        dp_j, jnp.zeros((1,)), jnp.asarray(y_full), key,
        jnp.asarray(4, jnp.int32), q_max=64, S_dense=S_j)
    at, bt, kt = t_lanczos.lanczos_alpha_beta_impl(
        dp_t, _t(y_full), _t(v0), 4, q_max=64, S_dense=_t(S_j))
    assert int(kt) == int(kj) == 4
    _close(at[:4], aj[:4], rtol=1e-9, atol=1e-11)
    _close(bt[:4], bj[:4], rtol=1e-9, atol=1e-11)
    # the same recurrence through the general apply_S (no S_dense)
    a2, b2, _ = t_lanczos.lanczos_alpha_beta_impl(
        dp_t, _t(y_full), _t(v0), 4, q_max=64)
    _close(a2[:4], at[:4], rtol=1e-9, atol=1e-11)
    # the block path on S_dense against the exact λ_min of S
    theta, margin, _ = t_block.block_lanczos_min_eig(
        dp_t, _t(y_full), torch.Generator().manual_seed(0), None, 1e-8, 4,
        b=8, k_max=5, S_dense=_t(S_j))
    lam_min = float(np.linalg.eigvalsh(np.asarray(S_j)[:40, :40])[0])
    assert theta - margin <= lam_min + 1e-9
    assert abs(theta - lam_min) < 1e-6


def test_dual_obj_entry_branch_matches_jax():
    """The end-of-solve fallback bound: the entry branch of dual_obj at
    the least-squares multiplier (ls_dual_entry), scalar Lanczos on S_dense
    from the same start vector."""
    dp_j, dp_t, _ = _pair(n=30, p=0.3, seed=4)
    R = _factor(dp_j, 3, 7)
    lam = np.random.default_rng(8).normal(size=dp_j.m)
    key = jax.random.PRNGKey(3)
    dv_j, eig_j, y_j = j_dualbound.dual_obj(
        dp_j, jnp.asarray(lam), jnp.asarray(2.0), jnp.zeros(dp_j.m + 1), 1.0,
        200, key, R=jnp.asarray(R))
    v0 = j_lanczos._lanczos_v0(dp_j, key, jnp.float64)
    dv_t, eig_t, y_t = t_dualbound.dual_obj(
        dp_t, _t(lam), _t(2.0), torch.zeros(dp_t.m + 1, dtype=F64), 1.0,
        200, torch.Generator(), R=_t(R), v0=_t(v0))
    _close(y_t, y_j, rtol=0, atol=1e-8 * float(np.max(np.abs(y_j))))
    assert abs(dv_t - dv_j) <= 1e-7 * max(1.0, abs(dv_j))
    assert abs(eig_t - eig_j) <= 1e-7 * max(1.0, abs(eig_j))


# ---------------------------------------------------------------- end to end

def test_maxcut_k2_entry_forced():
    """K₂ MaxCut: obj = -1 (reference: test/maxcut.jl:24); entry mode can
    be forced on a diagonal family."""
    C, As, b = t_models.maxcut(sp.csr_matrix(np.array([[0.0, 1.0],
                                                       [1.0, 0.0]])))
    res = sdplr(C, As, b, 2, entry_mode=True, dense_mode=False, ptol=1e-8,
                objtol=np.inf, printlevel=0, prior_trace_bound=2.0,
                device="cpu", dtype="float64")
    assert res["inner_engine"] == ENGINE_ENTRY
    assert abs(res["obj"] - (-1.0)) < 1e-6


def test_major_chunk_in_entry_mode_matches_jax():
    """The state machine on the entry engine: 30 inner steps across loose
    major boundaries (ptol 1e-9: no dual bound), the entry chunk, the
    re-sync through the general A_uu and apply_S, the infeasible branch;
    the same trajectory as the JAX package's to 1e-8."""
    from sdplrplus_tpu.solver import major as j_major
    from sdplrplus_tpu_torch.solver import major as t_major

    dp_j, dp_t, _ = _pair(n=14, p=0.45, seed=5)
    R = _factor(dp_j, 3, 4)
    lam = np.zeros(dp_j.m)
    k = 4
    cj = j_major.init_major_carry(
        dp_j, jnp.asarray(R), jnp.asarray(lam), 2.0, 0.5, 0.5,
        jax.random.PRNGKey(0), j_lbfgs_init(k, dp_j.n_pad, 3, jnp.float64),
        4, gtol_relative=True, ptol_relative=True)
    ct = t_major.init_major_carry(
        dp_t, _t(R), _t(lam), 2.0, 0.5, 0.5, torch.Generator(),
        t_lbfgs_init(k, dp_t.n_pad, 3, F64), 4, gtol_relative=True,
        ptol_relative=True)
    eps = np.finfo(np.float64).eps
    args = (30, 10 ** 5, 0, 1e8 * eps, 1e-9, 8 * eps, 1e-2, 2.0, 1.0, 4)
    kw = dict(k=k, use_armijo=False, gtol_relative=True, ptol_relative=True,
              objtol_relative=True, q_max=64, highprecision=False)
    jargs = [jnp.asarray(a, jnp.int32) if isinstance(a, int)
             else jnp.asarray(a, jnp.float64) for a in args]
    cj, vj = j_major.major_chunk(dp_j, cj, *jargs, 0, **kw)
    ct, vt = t_major.major_chunk(dp_t, ct, *args, None, **kw)
    assert int(cj.feas_count) == ct.feas_count == 0
    assert ct.majoriters == int(cj.majoriters) >= 1
    assert ct.ic.steps == int(cj.ic.steps)
    for name in ("lam", "sigma", "cur_ptol", "cur_gtol"):
        _close(getattr(ct, name), getattr(cj, name), rtol=1e-8)
    for name in ("R", "vio_raw", "L_val", "grad_norm"):
        _close(getattr(ct.ic, name), getattr(cj.ic, name), rtol=1e-8,
               atol=1e-8)
    _close(vt, vj, rtol=1e-8)
