"""The port's sharded solve (parallel/, slice G) against its single-device
run and the JAX package's shard_map, on the CPU.

Each world size (2 and 4) is one launch of gloo ranks, one process each
(tests/torch_spmd_cases.py, a ``file://`` rendezvous under tmp_path,
OMP_NUM_THREADS=1), that runs every case and returns its full outputs
as JSON; the tests hold them against the port's one-device run in this
process and against the JAX package's ``make_shardmap_inner``,
``make_shardmap_major`` and ``shard_map(apply_S)`` on 4 of the 8
virtual CPU devices, on the same numpy inputs. They mirror tests/test_sharded.py, tests/test_shardmap.py
and tests/test_halo.py; every tolerance is theirs (float64 throughout,
except the end-to-end solve, float32 as in test_halo.py:114).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_cases as cases
from sdplrplus_tpu_torch import SolverConfig, sdplr
from sdplrplus_tpu_torch.ops.adjoint import apply_S, apply_S_general, gradient
from sdplrplus_tpu_torch.ops.device import to_device
from sdplrplus_tpu_torch.ops.forward import A_uu, A_uv
from sdplrplus_tpu_torch.ops.lanczos import lanczos_v0
from sdplrplus_tpu_torch.solver.inner import inner_chunk
from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init
from sdplrplus_tpu_torch.solver.major import major_chunk

F64 = torch.float64
WORLDS = (2, 4)
CASES = ("inner_maxcut", "inner_minbisection", "ops_maxcut",
         "ops_minbisection", "major_sparse", "major_dense", "entry", "halo",
         "halo_inner")
_RESULTS = {}


def results(tmp_path_factory, nd):
    """Every case at world size ``nd``, from one launch per world size.
    The major cases' Lanczos bound starts from the JAX package's start
    vector (``jax_major``), passed to the ranks as an input."""
    if nd not in _RESULTS:
        v0 = {f"v0_{kind}": jax_major(kind)[0] for kind in ("sparse", "dense")}
        _RESULTS[nd] = cases.launch_ranks(
            str(tmp_path_factory.mktemp(f"spmd{nd}")), nd,
            CASES + (("solve",) if nd == 4 else ("paths",)), inputs=v0)
    return _RESULTS[nd]


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


# ---- ops (test_sharded.py:44-66) --------------------------------------------

@pytest.mark.parametrize("nd", WORLDS)
@pytest.mark.parametrize("gen", ["maxcut", "minbisection"])
def test_spmd_ops_match_single_device(tmp_path_factory, gen, nd):
    """𝒜(RRᵀ), 𝒜((RVᵀ+VRᵀ)/2), S·R (diagonal and general form), the
    gradient and the seeded Lanczos start vector (each rank draws the
    whole vector and keeps its rows), row-sharded over nd gloo ranks
    (all-gather layout), equal the one-device port to 1e-12
    (test_sharded.py's atol)."""
    got = results(tmp_path_factory, nd)[f"ops_{gen}"]
    prob, cp, R, V, y = cases.ops_inputs(gen, nd)
    dp = to_device(cp, F64)
    Rt, Vt, yt = torch.tensor(R), torch.tensor(V), torch.tensor(y)
    want = dict(
        A_uu=A_uu(dp, Rt), A_uv=A_uv(dp, Rt, Vt), S=apply_S(dp, yt, Rt),
        S_general=apply_S_general(dp, yt, Rt),
        G=gradient(dp, Rt, torch.tensor(-y[:prob.m]), 2.0, yt * 0.01)[0],
        v0=lanczos_v0(dp, torch.Generator().manual_seed(0), F64))
    for key, w in want.items():
        _close(got[key], w.numpy(), atol=1e-12, rtol=1e-12)


# ---- inner chunk (test_shardmap.py:25-69) -----------------------------------

_JAX_INNER = {}


def jax_shardmap_inner(gen):
    """The JAX package's make_shardmap_inner on 4 virtual devices, 12
    steps from the same inputs."""
    if gen in _JAX_INNER:
        return _JAX_INNER[gen]
    from sdplrplus_tpu import SDPProblem as JProblem
    from sdplrplus_tpu import compile_problem as j_compile
    from sdplrplus_tpu.ops.device import to_device as j_to_device
    from sdplrplus_tpu.parallel.shardmap import (
        make_shardmap_inner, shardmap_problem)
    from sdplrplus_tpu.parallel.spmd import make_mesh
    from sdplrplus_tpu.solver.al import al_value_grad as j_fg
    from sdplrplus_tpu.solver.lbfgs import lbfgs_init as j_lbfgs_init

    from sdplrplus_tpu import models as jm

    prob, _, R0 = cases.inner_setup(gen)
    A = jm.make_random_graph(48, 0.5, seed=7)
    jgen = jm.maxcut if gen == "maxcut" else jm.minimum_bisection
    C, As, b = jgen(A)[:3]
    cp = j_compile(JProblem(C, As, b, None), ell_width=64)
    dp1 = j_to_device(cp, jnp.float64)
    lam0 = jnp.zeros(prob.m)
    L, vio, G, y, gn, _ = jax.jit(
        j_fg, static_argnames=("gtol_relative", "ptol_relative"))(
        dp1, jnp.asarray(R0), lam0, 2.0, gtol_relative=True,
        ptol_relative=True)
    mesh = make_mesh(4)
    dp4, specs = shardmap_problem(cp, jnp.float64, mesh)
    run = make_shardmap_inner(mesh, specs, k=4, use_armijo=False)
    c, vn = run(dp4, jnp.asarray(R0), G, y, vio, L, gn,
                j_lbfgs_init(4, cp.n_pad, 3, jnp.float64), lam0,
                jnp.float64(2.0), jnp.float64(0.0), jnp.float64(-np.inf),
                jnp.int32(12))
    _JAX_INNER[gen] = (np.asarray(c.R), float(c.L_val), float(vn),
                       int(c.steps))
    return _JAX_INNER[gen]


@pytest.mark.parametrize("nd", WORLDS)
@pytest.mark.parametrize("gen", ["maxcut", "minbisection"])
def test_spmd_inner_chunk_matches(tmp_path_factory, gen, nd):
    """12 inner steps on nd gloo ranks against the port's one device (R
    atol 1e-9, L and grad_norm 1e-9 relative, vio_norm 1e-10: the
    tolerances of test_shardmap.py:61-67) and against the JAX package's
    shard_map on 4 devices (R atol 1e-8)."""
    got = results(tmp_path_factory, nd)[f"inner_{gen}"]
    prob, cp, R0 = cases.inner_setup(gen)
    dp = to_device(cp, F64)
    lam = torch.zeros(prob.m, dtype=F64)
    L, vio, G, y, gn, _ = cases.fg_state(dp, R0, lam, 2.0)
    c, vn = inner_chunk(dp, torch.tensor(R0), G, y, vio, L, gn,
                        lbfgs_init(4, cp.n_pad, 3, F64), lam, 2.0, 0.0,
                        -math.inf, 12, k=4, use_armijo=False,
                        gtol_relative=True, ptol_relative=True)
    assert got["steps"] == c.steps == 12
    _close(got["R"], c.R.numpy(), atol=1e-9)
    L1 = float(c.L_val)
    assert abs(got["L"] - L1) < 1e-9 * max(1.0, abs(L1))
    assert abs(got["vio_norm"] - float(vn)) < 1e-10
    assert abs(got["grad_norm"] - float(c.grad_norm)) < 1e-9
    jR, jL, jvn, jsteps = jax_shardmap_inner(gen)
    assert got["steps"] == jsteps
    _close(got["R"], jR, atol=1e-8)
    assert abs(got["L"] - jL) < 1e-8 * max(1.0, abs(jL))


# ---- major chunk (test_shardmap.py:72-128, :131-184) ------------------------

_JAX_MAJOR = {}


def jax_major(kind):
    """The JAX package's fused state machine on the inputs of the port's
    ``major_sparse`` / ``major_dense`` / ``entry`` cases, as
    test_shardmap.py:72-184 runs it: returns (v0, out), ``out`` the
    outputs of make_shardmap_major on 4 virtual devices, ``v0`` the
    Lanczos start vector it draws at its first strict boundary.

    The two packages draw start vectors from different generators, and
    the bound of this 48-step Lanczos without reorthogonalization differs
    between start vectors by up to 3.4e-5 relative (eight tried). So the port's cases
    start their bound from ``v0``: the JAX package's key is split once
    per feasible boundary (solver/major.py:294), and ``v0`` comes from
    the key of its one-device run after the last boundary before its
    first bound, found by running that prefix with major_budget 1, 2, …"""
    if kind in _JAX_MAJOR:
        return _JAX_MAJOR[kind]
    from sdplrplus_tpu import SDPProblem as JProblem
    from sdplrplus_tpu import compile_problem as j_compile
    from sdplrplus_tpu import models as jm
    from sdplrplus_tpu.ops import lanczos as j_lanczos
    from sdplrplus_tpu.ops.device import to_device as j_to_device
    from sdplrplus_tpu.parallel.shardmap import (
        make_shardmap_major, shardmap_problem)
    from sdplrplus_tpu.parallel.spmd import make_mesh
    from sdplrplus_tpu.solver.lbfgs import lbfgs_init as j_lbfgs_init
    from sdplrplus_tpu.solver.major import init_major_carry, major_chunk

    if kind == "entry":
        C, As, b = jm.lovasz_theta(jm.make_random_graph(40, 0.3, seed=11))
        cp = j_compile(JProblem(C, As, np.asarray(b, float), None),
                       entry=True, n_shards=4)
        R0, args = cases.entry_setup(4)[2], cases.ENTRY_ARGS
    else:
        C, As, b = jm.maxcut(jm.make_random_graph(48, 0.5, seed=3))[:3]
        cp = j_compile(JProblem(C, As, b, None), ell_width=64,
                       dense=kind == "dense")
        R0, args = cases.major_setup(kind == "dense")[2], cases.MAJOR_ARGS
    ints = ("budget", "major_budget", "base_iter", "rankupd_tol")
    sc = [(jnp.int32 if key in ints else jnp.float64)(v)
          for key, v in args.items()]
    dp1 = j_to_device(cp, jnp.float64)
    carry0 = init_major_carry(
        dp1, jnp.asarray(R0), jnp.zeros(cp.m, jnp.float64), 2.0,
        2.0 ** -0.1, 0.5, jax.random.PRNGKey(0),
        j_lbfgs_init(4, cp.n_pad, 3, jnp.float64), 4, gtol_relative=True,
        ptol_relative=True)
    v0 = None
    if kind != "entry":
        before = carry0
        for majors in range(1, args["major_budget"] + 1):
            out, _ = major_chunk(
                dp1, carry0, sc[0], jnp.int32(majors), *sc[2:], k=4,
                use_armijo=False, gtol_relative=True, ptol_relative=True,
                objtol_relative=True, q_max=64, highprecision=False)
            if int(out.feas_count) > 0:
                break
            before = out
        v0 = np.asarray(j_lanczos._lanczos_v0(
            dp1, jax.random.split(before.key)[1], jnp.float64))
    mesh = make_mesh(4)
    dp4, specs = shardmap_problem(cp, jnp.float64, mesh)
    run = make_shardmap_major(mesh, specs, k=4, use_armijo=False, q_max=64)
    c, vn = run(dp4, carry0, *sc)
    _JAX_MAJOR[kind] = v0, dict(
        steps=int(c.ic.steps), majoriters=int(c.majoriters),
        feas_count=int(c.feas_count), R=np.asarray(c.ic.R),
        lam=np.asarray(c.lam), vio_raw=np.asarray(c.ic.vio_raw),
        max_dual=float(c.max_dual), vio_norm=float(vn))
    return _JAX_MAJOR[kind]


def _single_major(cp, R0, args, v0=None):
    dp = to_device(cp, F64)
    kw = {} if v0 is None else dict(lanczos_v0=torch.tensor(v0))
    return major_chunk(dp, cases.major_carry0(dp, R0, 4), *args.values(),
                       k=4, use_armijo=False, gtol_relative=True,
                       ptol_relative=True, objtol_relative=True, q_max=64,
                       highprecision=False, **kw)


def _hold_major(got, want, vio_raw=False):
    """test_shardmap.py:116-128's tolerances: the same steps, majors and
    bounds, R and λ to 1e-8, the best dual to 1e-6 relative and the
    violation norm to 1e-9."""
    for key in ("steps", "majoriters", "feas_count"):
        assert got[key] == want[key], key
    for key in ("R", "lam") + (("vio_raw",) if vio_raw else ()):
        _close(got[key], want[key], atol=1e-8)
    md = want["max_dual"]
    assert abs(got["max_dual"] - md) < 1e-6 * max(1.0, abs(md))
    assert abs(got["vio_norm"] - want["vio_norm"]) < 1e-9


@pytest.mark.parametrize("nd", WORLDS)
@pytest.mark.parametrize("dense", [False, True])
def test_spmd_major_chunk_matches_single_device(tmp_path_factory, dense, nd):
    """The fused state machine (inner loop, Lanczos bound with row-sharded
    Krylov vectors, dual ascent, σ schedule) on nd gloo ranks equals the
    port's one-device run and the JAX package's shard_map on 4 devices
    across its major boundaries (the tolerances of test_shardmap.py,
    ``_hold_major``). Every run starts its one bound from the JAX
    package's start vector (``jax_major``): from it the port at 4 ranks
    moves the bound by 1e-8 (fast-diagonal) and 2e-8 (dense) relative,
    the JAX package on 4 devices by 5e-8 and 7e-8. From other start
    vectors both move it by up to 5e-5 (the port 4.5e-5 over eight, the
    JAX package 4.1e-5 over five), by the same mechanism: a
    rounding difference of the sharded row sums, grown by the
    recurrence once a Ritz value has converged."""
    kind = "dense" if dense else "sparse"
    got = results(tmp_path_factory, nd)[f"major_{kind}"]
    v0, jax_out = jax_major(kind)
    _, cp, R0 = cases.major_setup(dense)
    c, vn = _single_major(cp, R0, cases.MAJOR_ARGS, v0)
    assert c.feas_count == 1     # one bound, so one start vector
    _hold_major(got, dict(
        steps=c.ic.steps, majoriters=c.majoriters, feas_count=c.feas_count,
        R=c.ic.R.numpy(), lam=c.lam.numpy(), max_dual=float(c.max_dual),
        vio_norm=float(vn)))
    _hold_major(got, jax_out)


@pytest.mark.parametrize("nd", WORLDS)
def test_spmd_major_entry_mode_matches_single_device(tmp_path_factory, nd):
    """Lovász θ on the entry-mask engine with the (n, n) masks row-sharded
    over nd gloo ranks: the trajectory equals the port's one-device run
    and the JAX package's shard_map on 4 devices (R, violations and λ to
    1e-8, the violation norm to 1e-9, as test_shardmap.py:131-184)."""
    got = results(tmp_path_factory, nd)["entry"]
    _, jax_out = jax_major("entry")
    _, cp, R0 = cases.entry_setup(nd)
    c, vn = _single_major(cp, R0, cases.ENTRY_ARGS)
    assert c.ic.steps > 0
    _hold_major(got, dict(
        steps=c.ic.steps, majoriters=c.majoriters, feas_count=c.feas_count,
        R=c.ic.R.numpy(), lam=c.lam.numpy(), vio_raw=c.ic.vio_raw.numpy(),
        max_dual=float(c.max_dual), vio_norm=float(vn)), vio_raw=True)
    _hold_major(got, jax_out, vio_raw=True)


# ---- halo (test_halo.py) ----------------------------------------------------

@pytest.mark.parametrize("nd", WORLDS)
def test_halo_metadata_built_and_small(nd):
    _, cp = cases.halo_setup(nd)
    assert cp.halo_send is not None and cp.halo_send.shape[0] == nd
    n_loc = cp.n_pad // nd
    assert (nd - 1) * cp.halo_H < 0.5 * (cp.n_pad - n_loc)


@pytest.mark.parametrize("nd", WORLDS)
def test_halo_remap_consistency(nd):
    """The remapped ELL columns address, through [X_local; halo], exactly
    the global rows the raw columns address."""
    _, cp = cases.halo_setup(nd)
    n_loc, H = cp.n_pad // nd, cp.halo_H
    for s in range(nd):
        layout = np.full(n_loc + (nd - 1) * H, -1, dtype=np.int64)
        layout[:n_loc] = np.arange(s * n_loc, (s + 1) * n_loc)
        for t in range(1, nd):
            src = (s - t) % nd
            layout[n_loc + (t - 1) * H: n_loc + t * H] = (
                cp.halo_send[src, t - 1] + src * n_loc)
        got = layout[cp.halo_ell_cols[s * n_loc:(s + 1) * n_loc]]
        assert (got == cp.ell_cols[s * n_loc:(s + 1) * n_loc]).all()


def test_halo_volume_rule_picks_halo():
    """The volume rule picks the halo on the locality graph and the
    all-gather on a random one (JAX package: shardmap.py:67-80)."""
    from sdplrplus_tpu_torch.parallel.shardmap import halo_picked

    _, cp = cases.halo_setup(4)
    assert halo_picked(cp, 4)
    assert not halo_picked(cp, 4, halo=False)
    _, cp_r, _, _, _ = cases.ops_inputs("maxcut", 4)
    assert not halo_picked(cp_r, 4)
    with pytest.raises(ValueError, match="halo metadata built for 4"):
        halo_picked(cp, 2, halo=True)


_JAX_HALO = {}


def jax_halo_apply_S(nd):
    """The JAX package's apply_S under shard_map on 4 virtual devices with
    the halo forced (the same S·X whatever the world size)."""
    if "S" in _JAX_HALO:
        return _JAX_HALO["S"]
    from jax.sharding import Mesh, PartitionSpec as P

    from sdplrplus_tpu import SDPProblem as JProblem
    from sdplrplus_tpu.compile import compile_problem as j_compile
    from sdplrplus_tpu.ops.adjoint import apply_S as j_apply_S
    from sdplrplus_tpu.ops.adjoint import assemble_s_tri
    from sdplrplus_tpu.ops.device import to_device as j_to_device
    from sdplrplus_tpu.parallel.shardmap import AXIS, shardmap_problem

    from sdplrplus_tpu import models as jm

    _, cp = cases.halo_setup(4, dense=False)
    A = cases.synthetic_local_graph(512, 6, 16, seed=9)
    C, As, b = jm.maxcut(A)[:3]
    jcp = j_compile(JProblem(C, list(As), np.asarray(b, float), None),
                    n_shards=4, row_pad=128, nnz_pad=128, dense=False)
    y, X = cases.halo_inputs(cp)
    mesh = Mesh(np.array(jax.devices()[:4]), (AXIS,))
    dp1 = j_to_device(jcp, jnp.float64)
    s_tri = assemble_s_tri(dp1, jnp.asarray(y))
    dp_s, specs = shardmap_problem(jcp, jnp.float64, mesh, halo=True)
    assert dp_s.halo_send is not None
    mapped = jax.jit(jax.shard_map(
        j_apply_S, mesh=mesh, in_specs=(specs, P(), P(), P(AXIS, None)),
        out_specs=P(AXIS, None), check_vma=False))
    _JAX_HALO["S"] = np.asarray(mapped(dp_s, s_tri, jnp.asarray(y),
                                       jnp.asarray(X)))
    return _JAX_HALO["S"]


@pytest.mark.parametrize("nd", WORLDS)
def test_spmd_halo_apply_S(tmp_path_factory, nd):
    """S·X on nd gloo ranks, with the row support all-gathered and as a
    halo (ring shifts of the precomputed rows), through spmm_C and the
    general form, equals the one-device port to 1e-10 and the JAX
    package's halo shard_map on 4 devices to 1e-10 (float64; the JAX
    test's float32 tolerance is 1e-5)."""
    got = results(tmp_path_factory, nd)["halo"]
    _, cp = cases.halo_setup(nd, dense=False)
    y, X = cases.halo_inputs(cp)
    dp = to_device(cp, F64)
    want = apply_S(dp, torch.tensor(y), torch.tensor(X)).numpy()
    want_g = apply_S_general(dp, torch.tensor(y), torch.tensor(X)).numpy()
    jS = jax_halo_apply_S(nd)
    for halo in ("False", "True"):
        _close(got[f"S_{halo}"], want, atol=1e-10, rtol=1e-10)
        _close(got[f"Sg_{halo}"], want_g, atol=1e-10, rtol=1e-10)
        _close(got[f"S_{halo}"], jS, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("nd", WORLDS)
def test_spmd_halo_inner_chunk(tmp_path_factory, nd):
    """25 fast-diagonal inner steps with the halo exchange (the SpMM's
    gather on halo-remapped local ids) equal the one-device run: the
    same steps, R to 1e-9, L and grad_norm to 1e-9 relative."""
    got = results(tmp_path_factory, nd)["halo_inner"]
    prob, cp = cases.halo_setup(nd, dense=False)
    R0 = cases.halo_R0(cp)
    dp = to_device(cp, F64)
    lam = torch.zeros(prob.m, dtype=F64)
    L, vio, G, y, gn, _ = cases.fg_state(dp, R0, lam, 2.0)
    c, _ = inner_chunk(dp, torch.tensor(R0), G, y, vio, L, gn,
                       lbfgs_init(4, cp.n_pad, 4, F64), lam, 2.0, 0.0,
                       -math.inf, 25, k=4, use_armijo=False,
                       gtol_relative=True, ptol_relative=True)
    assert got["halo"] and got["steps"] == c.steps == 25
    _close(got["R"], c.R.numpy(), atol=1e-9)
    for key, w in (("L", float(c.L_val)), ("grad_norm", float(c.grad_norm))):
        assert abs(got[key] - w) <= 1e-9 * max(1.0, abs(w))


def test_spmd_solve_devices4_halo(tmp_path_factory):
    """solve(devices=4) on the locality graph of test_halo.py:114 reaches
    the one-device objective within 2e-2 with pinfeas ≤ 2e-2; the result
    names 4 devices and the halo engine and holds the whole factor."""
    from sdplrplus_tpu_torch.solver.outer import solve

    got = results(tmp_path_factory, 4)["solve"]
    prob, cfg = cases.solve_setup()
    res1 = solve(prob, 6, SolverConfig(**cfg))
    assert abs(got["obj"] - res1["obj"]) <= 2e-2 * abs(res1["obj"])
    assert got["primal_vio"] <= 2e-2
    assert got["devices"] == 4
    assert got["inner_engine"].endswith("+spmd-halo")
    assert got["R_rows"] == prob.n


@pytest.mark.parametrize("name", ["theta", "double"])
def test_spmd_solve_paths_match_single_device(tmp_path_factory, tmp_path,
                                              name):
    """sdplr(devices=2) through the outer loop's host-side paths on the
    rank-local problem (cases.paths_setup), against the same solve on one
    device. ``theta`` (60 iterations, then the final iterate's bound, the
    entry certificate from the gathered factor and wide weights, the
    DIMACS errors and the checkpoint): every value to 1e-8 relative, R
    and the checkpoint's factor to 1e-8. ``double`` (warm rank doubling
    1 → 4, to a certificate): the same rank, majors and bounds, the
    objective, its feasible value and the dual to 1e-6 relative, and the
    checkpoint holding the result's whole factor; the inner iterations
    may differ by a few, as the converged L-BFGS steps at rank 4 differ
    at the rounding level and the stop test falls on another step."""
    got = results(tmp_path_factory, 2)["paths"][name]
    (C, As, b), r, kw = cases.paths_setup()[name]
    ck = str(tmp_path / "ck.npz")
    res = sdplr(C, As, b, r, checkpoint_path=ck, **kw)
    assert got["devices"] == 2
    assert got["inner_engine"].startswith(res["inner_engine"] + "+spmd")
    for key in ("r", "majoriter", "dual_bounds_computed"):
        assert got[key] == res[key], key
    assert got["ck_r"] == res["r"]
    assert np.asarray(got["ck_R"]).shape == np.asarray(res["R"]).shape
    if name == "theta":
        assert got["iter"] == res["iter"]
        for key in ("obj", "obj_feasible", "max_dual_value", "primal_vio"):
            assert abs(got[key] - res[key]) <= 1e-8 * abs(res[key]), key
        _close(got["R"], res["R"], atol=1e-8)
        _close(got["DIMACS_errs"], res["DIMACS_errs"], atol=1e-8)
        with np.load(ck) as z:
            _close(got["ck_R"], z["R"], atol=1e-8)
    else:
        assert res["r"] == 4 and res["rel_duality_gap"] <= kw["objtol"]
        for key in ("obj", "obj_feasible", "max_dual_value"):
            assert abs(got[key] - res[key]) <= 1e-6 * abs(res[key]), key
        assert got["rel_duality_gap"] <= kw["objtol"]
        _close(got["ck_R"], got["R"], atol=0.0)


# ---- entry points -----------------------------------------------------------

def test_sdplr_devices2_spawns_workers(monkeypatch):
    """sdplr(devices=2, device="cpu") starts two gloo workers and returns
    rank 0's result: the one-device objective to 1e-8 relative in float64
    and the whole factor."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    from sdplrplus_tpu_torch.models import make_random_graph, maxcut

    C, As, b = maxcut(make_random_graph(40, 0.5, seed=5))[:3]
    kw = dict(device="cpu", dtype="float64", ptol=1e-4, objtol=1e-4,
              printlevel=0, prior_trace_bound=40.0)
    r1 = sdplr(C, As, b, 3, **kw)
    r2 = sdplr(C, As, b, 3, devices=2, **kw)
    assert r2["devices"] == 2 and "+spmd" in r2["inner_engine"]
    assert r2["inner_engine"].startswith(r1["inner_engine"])
    assert abs(r2["obj"] - r1["obj"]) <= 1e-8 * abs(r1["obj"])
    assert np.asarray(r2["R"]).shape == np.asarray(r1["R"]).shape


def test_mesh_and_external_model_refusals():
    """A mesh of 2 ranks needs a process per rank; an external model
    runs on one device; the host-driven loop is not sharded."""
    import torch.distributed as dist

    from sdplrplus_tpu_torch.adapter import dense_model
    from sdplrplus_tpu_torch.parallel.spmd import make_mesh
    from sdplrplus_tpu_torch.solver.outer import solve_model

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="one process per rank"):
        make_mesh(2)
    m = dense_model(np.array([[-.25, .25], [.25, -.25]]),
                    [np.diag([1., 0.]), np.diag([0., 1.])], np.ones(2),
                    dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="one device"):
        solve_model(m, 1, devices=2)
