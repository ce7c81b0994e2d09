"""The port's device-resident inner loop (solver/inner.py: the masked
K-step chunk program, one host read per chunk, and its graph runner's
bookkeeping) and the batched Armijo line search (solver/linesearch.py)
against the JAX package's ``inner_chunk``, ``major_chunk`` and
``armijo_from_products``, in float64 on the CPU.

The same numpy-seeded inputs go through both packages, on each engine:
dense (C held dense), fast-diagonal with the exact line search,
fast-diagonal with Armijo (μ-conductance) and general (θ outside entry
mode). Steps, exit flags and ring heads must be equal; R, G, the
violations and the ring agree to 1e-9 relative (absolute floor 1e-12);
the batched Armijo's α equals the sequential loop's bit for bit and its
L(α) agrees to 1e-12 relative.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdplrplus_tpu.ops.device import to_device as j_to_device
from sdplrplus_tpu.solver import inner as j_inner
from sdplrplus_tpu.solver import lbfgs as j_lbfgs
from sdplrplus_tpu.solver import linesearch as j_linesearch
from sdplrplus_tpu.solver import major as j_major
from sdplrplus_tpu.solver.al import al_value_grad as j_al_value_grad

from sdplrplus_tpu_torch.ops import forward as t_forward
from sdplrplus_tpu_torch.ops import spmm as t_spmm
from sdplrplus_tpu_torch.ops.device import (
    fast_diag_eligible, to_device as t_to_device,
)
from sdplrplus_tpu_torch.solver import inner as t_inner
from sdplrplus_tpu_torch.solver import lbfgs as t_lbfgs
from sdplrplus_tpu_torch.solver import linesearch as t_linesearch
from sdplrplus_tpu_torch.solver import major as t_major

from test_torch_armijo import setup_case
from test_torch_general import _pair, _padded
from test_torch_modules import _close, _problems, _t

F64 = torch.float64
ENGINES = ("dense", "fast-diag", "fast-diag-armijo", "general")
K_RING = 4        # L-BFGS ring slots
RTOL, ATOL = 1e-9, 1e-12
_CASES = {}


def _engine(engine):
    """(dp_j, dp_t, R0, lam, use_armijo) of the engine's case, built once."""
    if engine not in _CASES:
        if engine in ("dense", "fast-diag"):
            cp_j, cp_t = _problems("maxcut", n=24, dense=engine == "dense")
            dp_j = j_to_device(cp_j, jnp.float64)
            dp_t = t_to_device(cp_t, F64, "cpu")
            rng = np.random.default_rng(1)
            R0 = _padded(rng.uniform(-1, 1, (dp_t.n, 3)), dp_t.n_pad)
            lam = 0.1 * rng.standard_normal(dp_t.m)
            case = (dp_j, dp_t, R0, lam, False)
        elif engine == "fast-diag-armijo":
            case = setup_case("mucond") + (True,)
        else:
            dp_j, dp_t, _ = _pair(20, 0.4, seed=3)
            rng = np.random.default_rng(1)
            R0 = _padded(rng.uniform(-1, 1, (dp_t.n, 3)), dp_t.n_pad)
            case = (dp_j, dp_t, R0, np.zeros(dp_t.m), False)
        dp_t = case[1]
        got = ("general" if t_forward.is_general(dp_t)
               else "dense" if dp_t.C_dense is not None
               else "fast-diag-armijo" if dp_t.has_inequalities
               else "fast-diag")
        assert got == engine and (engine.startswith("fast-diag")
                                  == fast_diag_eligible(dp_t))
        _CASES[engine] = case
    return _CASES[engine]


def _start(engine):
    """The JAX start state (L, vio, G, y, grad_norm) at R0, σ = 2."""
    dp_j, _, R0, lam, _ = _engine(engine)
    return j_al_value_grad(dp_j, jnp.asarray(R0), jnp.asarray(lam),
                           jnp.asarray(2.0), True, True)[:5]


def _jax_chunk(engine, gtol, stag, steps, compact=True):
    dp_j, _, R0, lam, arm = _engine(engine)
    L, vio, G, y, gn = _start(engine)
    return j_inner.inner_chunk(
        dp_j, jnp.asarray(R0), G, y, vio, L, gn,
        j_lbfgs.lbfgs_init(K_RING, dp_j.n_pad, R0.shape[1], jnp.float64),
        jnp.asarray(lam), jnp.asarray(2.0), jnp.asarray(gtol),
        jnp.asarray(stag), steps, k=K_RING, use_armijo=arm,
        gtol_relative=True, ptol_relative=True, lbfgs_compact=compact)


def _torch_chunk(engine, gtol, stag, steps, compact=True, **kw):
    _, dp_t, R0, lam, arm = _engine(engine)
    L, vio, G, y, gn = (_t(x) for x in _start(engine))
    return t_inner.inner_chunk(
        dp_t, _t(R0), G, y, vio, L, gn,
        t_lbfgs.lbfgs_init(K_RING, dp_t.n_pad, R0.shape[1], F64), _t(lam),
        _t(2.0), gtol, stag, steps, k=K_RING, use_armijo=arm,
        gtol_relative=True, ptol_relative=True, lbfgs_compact=compact, **kw)


def _chunk_k(monkeypatch, K):
    """Chunks of K steps on CPU tensors (the card's K, ``CHUNK_K``, too)."""
    monkeypatch.setattr(t_inner, "CPU_CHUNK_K", K)
    monkeypatch.setattr(t_inner, "CHUNK_K", K)


def _compare(ct, vt, cj, vj):
    assert ct.steps == int(cj.steps)
    assert ct.stagnated == bool(cj.stagnated)
    assert ct.lbfgs.head == int(cj.lbfgs.head)
    for name in ("R", "G", "vio_raw", "L_val", "grad_norm"):
        _close(getattr(ct, name), getattr(cj, name), rtol=RTOL, atol=ATOL,
               what=name)
    for name in ("s_hist", "y_hist", "rho", "sty", "yty"):
        _close(getattr(ct.lbfgs, name), getattr(cj.lbfgs, name), rtol=RTOL,
               atol=ATOL, what=name)
    _close(vt, vj, rtol=RTOL)


# ------------------------------------------ (a) the masked K-step program

@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("engine", ENGINES)
def test_masked_chunks_match_jax_inner_chunk(engine, K, monkeypatch):
    """11 steps (a budget that 3 and 8 do not divide) in chunks of K
    masked steps against the JAX package's while_loop: the same steps,
    exit, ring and state; the chunks run are ⌈11/K⌉, one host read
    each, and the masked steps fill the last chunk."""
    _chunk_k(monkeypatch, K)
    cj, vj = _jax_chunk(engine, 1e-14, -np.inf, 11)
    t_inner.STATS.clear()
    ct, vt = _torch_chunk(engine, 1e-14, float("-inf"), 11)
    assert ct.steps == 11
    _compare(ct, vt, cj, vj)
    st = t_inner.STATS
    assert st["chunks"] == st["reads"] == math.ceil(11 / K)
    assert st["masked"] == K * st["chunks"] - 11 and st["replays"] == 0


def test_two_loop_chunks_match_jax(monkeypatch):
    """The two-loop recursion with the ring head on the device (indexed
    by tensors, so it runs in the chunk program as the compact form
    does): 11 steps in chunks of 3 against the JAX package's two-loop."""
    _chunk_k(monkeypatch, 3)
    cj, vj = _jax_chunk("dense", 1e-14, -np.inf, 11, compact=False)
    ct, vt = _torch_chunk("dense", 1e-14, float("-inf"), 11, compact=False)
    _compare(ct, vt, cj, vj)


# -------------------------------------------------- (b) exits mid-chunk

def _trajectory(engine, steps=8):
    """The JAX loop's (L, grad_norm) after 0..steps steps, no early exit."""
    out = []
    for s in range(steps + 1):
        c, _ = _jax_chunk(engine, 1e-14, -np.inf, s)
        out.append((float(c.L_val), float(c.grad_norm)))
    return out


@pytest.mark.parametrize("exit_", ["gtol", "stagnation", "budget"])
@pytest.mark.parametrize("engine", ENGINES)
def test_exit_mid_chunk_matches_jax(engine, exit_, monkeypatch):
    """Each exit inside a chunk of K = 8: the gradient tolerance (set just
    above the smallest norm of steps 1..6, below the starting one),
    stagnation (stag_tol just above the smallest relative decrease of
    steps 1..6; the stagnating step pushes no pair, so the ring is the
    one of the step before) and a budget of 5. The host reads once: the
    exit lies in the first chunk."""
    _chunk_k(monkeypatch, 8)
    gtol, stag, budget = 1e-14, -np.inf, 30
    if exit_ == "gtol":
        gn = [g for _, g in _trajectory(engine, 6)]
        gtol = min(gn[1:]) * (1 + 1e-6)
        assert gtol < gn[0]
    elif exit_ == "stagnation":
        tr = [L for L, _ in _trajectory(engine, 6)]
        rel = [(tr[s - 1] - tr[s]) / max(1.0, abs(tr[s]), abs(tr[s - 1]))
               for s in range(1, 7)]
        stag = min(rel) * (1 + 1e-6) if min(rel) > 0 else min(rel) / 2
    else:
        budget = 5
    cj, vj = _jax_chunk(engine, gtol, stag, budget)
    t_inner.STATS.clear()
    ct, vt = _torch_chunk(engine, gtol, stag, budget)
    assert 0 < ct.steps < 8 and t_inner.STATS["reads"] == 1
    _compare(ct, vt, cj, vj)
    if exit_ == "stagnation":
        assert ct.stagnated
        before, _ = _torch_chunk(engine, gtol, stag, ct.steps - 1)
        assert ct.lbfgs.head == before.lbfgs.head
        for name in ("s_hist", "y_hist", "rho", "sty", "yty"):
            assert torch.equal(getattr(ct.lbfgs, name),
                               getattr(before.lbfgs, name)), name


def _nan_at(monkeypatch, call):
    """Make the exact line search return a NaN L on its ``call``-th call
    (a step's other outputs stay finite)."""
    real = t_inner.exact_linesearch
    calls = [0]

    def patched(*a, **k):
        alpha, L, vio = real(*a, **k)
        calls[0] += 1
        return alpha, (L * math.nan if calls[0] == call else L), vio

    monkeypatch.setattr(t_inner, "exact_linesearch", patched)


def test_nan_stops_the_chunk_at_that_step(monkeypatch):
    """A NaN L at step 3 (dense engine, K = 8): that step is taken, the
    next is not (the healthy test), and the host stops after its read;
    R equals three clean steps bit for bit."""
    _chunk_k(monkeypatch, 8)
    clean, _ = _torch_chunk("dense", 1e-14, float("-inf"), 3)
    _nan_at(monkeypatch, 3)
    ct, _ = _torch_chunk("dense", 1e-14, float("-inf"), 30)
    assert ct.steps == 3 and math.isnan(float(ct.L_val))
    assert math.isfinite(float(ct.grad_norm))
    assert torch.equal(ct.R, clean.R)


def test_nan_stops_major_chunk_as_healthy_does(monkeypatch):
    """The same NaN inside major_chunk: the state machine stops at that
    step, as its healthy() test did, with no major boundary crossed."""
    _chunk_k(monkeypatch, 8)
    _, dp_t, R0, lam, _ = _engine("dense")
    ct = t_major.init_major_carry(
        dp_t, _t(R0), _t(lam), 2.0, 0.5, 1e-14, torch.Generator(),
        t_lbfgs.lbfgs_init(K_RING, dp_t.n_pad, R0.shape[1], F64), 4,
        gtol_relative=True, ptol_relative=True)
    _nan_at(monkeypatch, 3)
    out, _ = t_major.major_chunk(dp_t, ct, *_major_args(40), None, **_MKW)
    assert out.ic.steps == 3 and out.majoriters == 0
    assert math.isnan(float(out.ic.L_val))


# --------------------------------------------------- (c) batched Armijo

def _armijo_inputs(case, m=40):
    rng = np.random.default_rng({"random0": 0, "random1": 1, "random2": 2,
                                 "pass_at_0": 3, "exhausted": 4}[case])
    lam = 0.3 * rng.standard_normal(m)
    ub = np.where(rng.random(m) < 0.5, np.inf, lam + rng.random(m))
    vio = rng.standard_normal(m + 1)
    A_RD = rng.standard_normal(m + 1)
    A_DD = np.abs(rng.standard_normal(m + 1))
    sigma = 2.0
    y = np.r_[-np.minimum(ub, lam - sigma * vio[:m]), 1.0]
    if case == "pass_at_0":          # a steep descent: α_max passes
        A_RD[m], A_DD[:] = -50.0, 1e-3 * A_DD
    elif case == "exhausted":        # a claimed slope far below the true
        A_RD[m] = 1.0                # one: no candidate passes
        y[:m] = -1e6 * np.sign(A_RD[:m])
    return dict(lam=lam, ub=ub, vio=vio, A_RD=A_RD, A_DD=A_DD, sigma=sigma,
                y=y, m=m)


def _sequential_armijo(d):
    """The backtracking loop, one candidate at a time in numpy float64."""
    m = d["m"]

    def L_of(a):
        g = d["vio"][:m] + a * d["A_RD"][:m] + a * a * d["A_DD"][:m]
        lt = np.minimum(d["ub"], d["lam"] - d["sigma"] * g)
        return (d["vio"][m] + a * d["A_RD"][m] + a * a * d["A_DD"][m]
                + np.sum(lt * lt - d["lam"] ** 2) / (2 * d["sigma"]))

    L0 = L_of(0.0)
    slope = d["A_RD"][m] + d["y"][:m] @ d["A_RD"][:m]
    a, halvings = 1.0, 0
    while halvings < 50 and L_of(a) > L0 + 1e-4 * a * slope:
        a, halvings = a / 2, halvings + 1
    return a, L_of(a), halvings


@pytest.mark.parametrize("case", ["random0", "random1", "random2",
                                  "pass_at_0", "exhausted"])
def test_batched_armijo_matches_sequential_and_jax(case):
    d = _armijo_inputs(case)
    a_seq, L_seq, halvings = _sequential_armijo(d)
    if case == "pass_at_0":
        assert halvings == 0
    if case == "exhausted":
        assert halvings == 50
    dp_t = types.SimpleNamespace(m=d["m"], lam_ub=_t(d["ub"]))
    dp_j = types.SimpleNamespace(m=d["m"], lam_ub=jnp.asarray(d["ub"]))
    at, Lt, vt = t_linesearch.armijo_from_products(
        dp_t, _t(d["A_RD"]), _t(d["A_DD"]), _t(d["vio"]), _t(d["lam"]),
        _t(d["sigma"]), _t(d["y"]))
    aj, Lj, vj = j_linesearch.armijo_from_products(
        dp_j, *(jnp.asarray(d[k]) for k in ("A_RD", "A_DD", "vio", "lam",
                                            "sigma", "y")))
    assert float(at) == a_seq == float(aj)
    _close(Lt, L_seq, rtol=1e-12)
    _close(Lt, Lj, rtol=1e-12)
    _close(vt, vj, rtol=1e-12, atol=1e-15)


# ------------------------------------------------------- (d) major_chunk

_MKW = dict(k=K_RING, use_armijo=False, gtol_relative=True,
            ptol_relative=True, objtol_relative=True, q_max=64,
            highprecision=False)


def _major_args(budget):
    # ptol 1e-9 keeps every boundary loose: no Lanczos bound is drawn
    return (budget, 10 ** 5, 0, 1e8 * np.finfo(float).eps, 1e-9,
            8 * np.finfo(float).eps, 1e-2, 2.0, 24.0, 4)


@pytest.mark.parametrize("K", [3, 8])
@pytest.mark.parametrize("engine", ["dense", "general"])
def test_major_chunk_matches_jax(engine, K, monkeypatch):
    """80 steps of the state machine (inner activations in chunks of K,
    σ updates, re-syncs) against the JAX package's major_chunk."""
    import jax

    _chunk_k(monkeypatch, K)
    dp_j, dp_t, R0, lam, _ = _engine(engine)
    r = R0.shape[1]
    cj = j_major.init_major_carry(
        dp_j, jnp.asarray(R0), jnp.asarray(lam), 2.0, 0.5, 0.5,
        jax.random.PRNGKey(0),
        j_lbfgs.lbfgs_init(K_RING, dp_j.n_pad, r, jnp.float64), 4,
        gtol_relative=True, ptol_relative=True)
    ct = t_major.init_major_carry(
        dp_t, _t(R0), _t(lam), 2.0, 0.5, 0.5, torch.Generator(),
        t_lbfgs.lbfgs_init(K_RING, dp_t.n_pad, r, F64), 4,
        gtol_relative=True, ptol_relative=True)
    args = _major_args(80)
    jargs = [jnp.asarray(a, jnp.int32) if isinstance(a, int)
             else jnp.asarray(a, jnp.float64) for a in args]
    cj, vj = j_major.major_chunk(dp_j, cj, *jargs, 0, **_MKW)
    ct, vt = t_major.major_chunk(dp_t, ct, *args, None, **_MKW)
    assert int(cj.feas_count) == 0 and int(cj.majoriters) >= 2
    assert ct.majoriters == int(cj.majoriters)
    assert ct.ic.steps == int(cj.ic.steps)
    for name in ("lam", "sigma", "cur_ptol", "cur_gtol"):
        _close(getattr(ct, name), getattr(cj, name), rtol=RTOL, what=name)
    for name in ("R", "vio_raw", "L_val", "grad_norm"):
        _close(getattr(ct.ic, name), getattr(cj.ic, name), rtol=RTOL,
               atol=ATOL, what=name)
    _close(vt, vj, rtol=RTOL)


# ------------------------------------------------ (e) reads and launches

@pytest.mark.parametrize("K", [1, 3, 8])
def test_reads_per_activation(K, monkeypatch):
    """At most ⌈steps/K⌉ + 1 host reads per activation: a full budget of
    20, a gradient-tolerance exit, and an empty activation (one read)."""
    _chunk_k(monkeypatch, K)
    gtol_exit = min(g for _, g in _trajectory("fast-diag", 8)[1:]) * (1 + 1e-6)
    for gtol, want_steps in ((1e-14, 20), (gtol_exit, None), (1e9, 0)):
        t_inner.STATS.clear()
        c, _ = _torch_chunk("fast-diag", gtol, float("-inf"), 20)
        if want_steps is not None:
            assert c.steps == want_steps
        reads = t_inner.STATS["reads"]
        assert reads <= math.ceil(c.steps / K) + 1
        assert reads == max(math.ceil(c.steps / K), 1)


def test_cpu_chunks_take_one_step():
    """On CPU tensors a chunk is one step (a host read costs nothing
    there, a masked step a whole step): no step is masked, one read per
    step; on the card K = ``CHUNK_K``."""
    assert t_inner.CPU_CHUNK_K == 1
    assert t_inner.chunk_steps("cpu") == 1
    assert t_inner.chunk_steps("cuda") == t_inner.CHUNK_K > 1
    t_inner.STATS.clear()
    c, _ = _torch_chunk("general", 1e-14, float("-inf"), 11)
    st = t_inner.STATS
    assert c.steps == 11 and st["masked"] == 0
    assert st["chunks"] == st["reads"] == 11


class _StandInGraph(t_inner._InnerGraph):
    """The graph runner with its two CUDA pieces replaced on the CPU: the
    warm-up steps run eagerly, and the capture records the K-step program
    (running it once, as a capture calls the wrappers), which each replay
    runs again with every counter left as it was (no Python runs in a
    real replay)."""

    def _warm_up(self):
        for _ in range(t_inner.WARMUP_STEPS):
            self._program(1)
        t_inner.STATS["warmup_steps"] += t_inner.WARMUP_STEPS

    def _capture(self):
        program = lambda: self._program(self.K)
        program()
        self.graph = types.SimpleNamespace(
            replay=lambda: t_inner.launches_of(program))


def test_replay_bookkeeping_adds_launches_per_capture(monkeypatch):
    """The runner's counters under replay: the capture's calls are taken
    back, each replay adds the calls of one capture (K SpMMs on the
    fast-diagonal engine), and the warm-up's real steps stay counted, so
    the ELL SpMMs equal the eager program's plus the warm-up's. The
    results equal the eager program's bit for bit, and a second run
    through the same graph (new multipliers) needs no capture."""
    K = 4
    _chunk_k(monkeypatch, K)
    monkeypatch.setattr(t_inner, "_InnerGraph", _StandInGraph)
    graphs = t_inner.InnerGraphs()
    for scale in (1.0, 0.5):
        runs = {}
        for graph in (False, True):
            t_inner.STATS.clear()
            t_spmm.CALLS.clear()
            _, dp_t, R0, lam, _ = _engine("fast-diag")
            L, vio, G, y, gn = (_t(x) for x in _start("fast-diag"))
            c, _ = t_inner.inner_chunk(
                dp_t, _t(R0), G, y, vio, L, gn,
                t_lbfgs.lbfgs_init(K_RING, dp_t.n_pad, R0.shape[1], F64),
                _t(scale * lam), _t(2.0), 1e-14, float("-inf"), 13,
                k=K_RING, use_armijo=False, gtol_relative=True,
                ptol_relative=True, graph=graph, graphs=graphs)
            runs[graph] = (c, dict(t_inner.STATS), t_spmm.CALLS["spmm_ell"])
        (ce, se, ne), (cg, sg, ng) = runs[False], runs[True]
        assert ce.steps == cg.steps == 13 and ce.lbfgs.head == cg.lbfgs.head
        for name in ("R", "G", "vio_raw", "L_val", "CX"):
            assert torch.equal(getattr(ce, name), getattr(cg, name)), name
        assert sg["replays"] == se["chunks"] == math.ceil(13 / K)
        warm = t_inner.WARMUP_STEPS if scale == 1.0 else 0
        assert sg.get("captures", 0) == (1 if scale == 1.0 else 0)
        assert sg.get("warmup_steps", 0) == warm
        # one SpMM for CX at entry, then one per masked step
        assert ne == 1 + K * se["chunks"]
        assert ng == ne + warm
