"""The harness's problem interface on the CPU: an instance brings its own
constraints, constraint types, trace bound, parameters and TF32 control,
through ``make_pool``, ``Loop.solve``, ``check.judge`` and
``control.readings``; and the MaxCut cells' pools, shared constraints,
solver call and readings stay as they were."""

import hashlib
import os
import sys

import numpy as np
import pytest

import sdplrplus_tpu_torch
from portbench import check, control, harness, port
from portbench.families import gnp, torus
from portbench.instance import Instance, resolve_trace_bound
from portbench.reference import maxcut
from portbench.tests import mucond_toy

ROOT = os.path.dirname(harness.HERE)
MU = 0.1
TOY = {"problem": "mucond_toy", "params": {"mu": MU}, "family": "gnp",
       "graph": {"n": 40, "density_pct": 20},
       "solver": {"r0": 4, "ptol": 0.01, "objtol": 0.01,
                  "trace_bound": "instance", "dtype": "float64",
                  "lbfgs_pairs": 4},
       "check": {"sample": 2, "limits": {"obj_dev": 1.0, "pinfeas_dev": 1.0,
                                         "bound_over": 1.0}}}
TOY_MIX = {"loop": "closed", "pool": 2, "maxtime_s": 10, "trace_solves": 0}


@pytest.fixture
def toy(monkeypatch):
    """The test's problem, found by name as a configuration's is."""
    monkeypatch.setitem(sys.modules, "portbench.reference.mucond_toy",
                        mucond_toy)
    mucond_toy.CERTIFIED.clear()
    mucond_toy.CONTROLLED.clear()
    return mucond_toy


def test_params_reach_formulation(toy):
    for mu in (0.1, 0.25):
        config = dict(TOY, params={"mu": mu})
        pool = harness.make_pool(config, TOY_MIX, np.random.default_rng(3))
        for inst in pool:
            vol = float(np.sum(inst.C.diagonal()))
            assert inst.params == {"mu": mu}
            assert inst.trace_bound == pytest.approx(
                40 * (1 - mu) / (mu * vol), rel=1e-15)
            assert inst.b[2] == pytest.approx((1 - mu) / (mu * vol))


def test_trace_bound_follows_the_instance():
    sparse = mucond_toy.formulation(gnp.graph({"n": 40, "density_pct": 20},
                                              1), MU)
    dense = mucond_toy.formulation(gnp.graph({"n": 40, "density_pct": 40},
                                             1), MU)
    assert resolve_trace_bound("instance", sparse) == sparse.trace_bound
    assert sparse.trace_bound == pytest.approx(2 * dense.trace_bound,
                                               rel=1e-2)
    assert resolve_trace_bound("n", sparse) == 40.0
    assert resolve_trace_bound(12, sparse) == 12.0
    with pytest.raises(ValueError, match="trace_bound"):
        resolve_trace_bound("vol", sparse)


@pytest.fixture
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_instance_with_its_own_constraints_through_the_loop(
        toy, few_threads, monkeypatch):
    rng = np.random.default_rng(2147483905)
    pool = harness.make_pool(TOY, TOY_MIX, rng)
    ops = port.operands(pool)
    assert [len(a) for a in ops] == [82, 82] and ops[0] is not ops[1]
    assert isinstance(ops[0][1], sdplrplus_tpu_torch.SymLowRank)

    calls = []
    real = sdplrplus_tpu_torch.sdplr

    def spy(C, As, b, r, **kw):
        calls.append((C, As, b, kw))
        return real(C, As, b, r, **kw)

    def refuse(*args, **kwargs):
        raise AssertionError("a constraint was built inside Loop.solve")

    monkeypatch.setattr(sdplrplus_tpu_torch, "sdplr", spy)
    for name in ("sparse_coo", "SymLowRank"):
        monkeypatch.setattr(sdplrplus_tpu_torch, name, refuse)
    for name in ("operands", "constraints"):
        monkeypatch.setattr(port, name, refuse)
    loop = harness.Loop(pool, ops, TOY, TOY_MIX, rng, "cpu")
    records = [loop.solve() for _ in range(3)]

    assert [s["instance"] for s in records] == [0, 1, 0]
    for s, (C, As, b, kw) in zip(records, calls):
        inst = pool[s["instance"]]
        assert "error" not in s, s.get("error")
        assert C is inst.C and b is inst.b and As is ops[s["instance"]]
        assert kw["constraint_types"] is inst.types
        assert kw["constraint_types"].sum() == 80
        assert kw["prior_trace_bound"] == inst.trace_bound
    correct, table, checked = check.judge(records, pool, TOY, 7)
    assert len(mucond_toy.CERTIFIED) == len(checked) == 2
    for i, got in zip(checked, mucond_toy.CERTIFIED):
        assert got is pool[records[i]["instance"]]
    assert all(np.isfinite(v) for v, _ in table.values())


@pytest.fixture
def toy_cell(toy, monkeypatch):
    """A cell of the test's problem, as ``load_cell`` would read it from
    BENCHMARK.json."""
    real = harness.load_cell

    def load_cell(root, workload):
        if workload != "mucond_toy.cell":
            return real(root, workload)
        cell = {"name": workload, "config": "mucond_toy",
                "traffic": "toy", "chips": 1, "why": "test"}
        return {}, cell, TOY, TOY_MIX

    monkeypatch.setattr(harness, "load_cell", load_cell)
    return "mucond_toy.cell"


def test_control_readings_take_the_problems_own_control(
        toy, toy_cell, few_threads):
    outs = list(control.readings(ROOT, toy_cell, [2147483905, 6], 1e-3,
                                 device="cpu"))
    assert [o["seed"] for o in outs] == [2147483905, 6]
    for out in outs:
        assert out["solves"] >= 1 and out["checked"] >= 1
        assert set(out["control"]) == set(out["program"]) == {
            "pinfeas", "gap", "obj_dev", "pinfeas_dev", "bound_over"}
        assert all(np.isfinite(v) for v in out["control"].values())
        assert isinstance(out["control_correct"], bool)
    # the control was handed the checked solves' own instances, which the
    # reference certified twice: once for the program, once for the control
    checked = sum(o["checked"] for o in outs)
    assert len(toy.CONTROLLED) == checked
    assert len(toy.CERTIFIED) == 2 * checked
    assert {id(i) for i in toy.CONTROLLED} <= {id(i) for i in toy.CERTIFIED}


def test_a_problem_without_a_control_stops_by_name(toy, toy_cell,
                                                   monkeypatch):
    monkeypatch.delattr(toy, "certify_tf32")

    def refuse(*args, **kwargs):
        raise AssertionError("a solve ran before the control was looked up")

    monkeypatch.setattr(port, "solve", refuse)
    with pytest.raises(LookupError, match=r"reference/mucond_toy\.py has no "
                                          r"certify_tf32"):
        next(control.readings(ROOT, toy_cell, [1], 1.0, device="cpu"))
    assert callable(control.control_of(dict(TOY, problem="maxcut")))


def test_maxcut_call_is_the_call_it_was(monkeypatch):
    """A MaxCut instance reaches ``sdplr`` with the keywords and values
    it always had: no constraint types, the trace bound n."""
    _, _, config, mix = harness.load_cell(ROOT, "maxcut-g1.gset")
    pool = harness.make_pool(config, dict(mix, pool=2),
                             np.random.default_rng(0))
    ops = port.operands(pool)
    calls = []
    monkeypatch.setattr(sdplrplus_tpu_torch, "sdplr",
                        lambda *a, **kw: calls.append((a, kw)))
    port.solve(pool[1], ops[1], config["solver"], seed=5, maxtime=10.0,
               device="cpu")
    (args, kw), = calls
    assert args == (pool[1].C, ops[1], pool[1].b, 10)
    assert kw == {"ptol": 0.01, "objtol": 0.01, "prior_trace_bound": 800.0,
                  "numlbfgsvecs": 4, "dtype": "float32", "printlevel": 0,
                  "seed": 5, "maxtime": 10.0, "device": "cpu"}


# sha256 of each instance's C.data, C.indices, C.indptr and b, in pool
# order, for make_pool at the run seeds 0, 1, 2 (as the harness built them
# before instances carried their own constraints)
POOLS = {
    "maxcut-g81.gset": [
        "73a80954e8b1521e2afa8b7c827b0f6ee730e5801656d200a4f5bce44e2da83c",
        "82fdbf4e64de159c0e97c458d5fd7f8ba8747e4b46271ba1d6576570ad2413ed",
        "b0d5df7785b632acf67a82e581a684923771cbc3e37c684fd9a6c1991546c093"],
    "maxcut-g1.gset": [
        "46d82e6a839044bfa7e54bcd01ef096aa224462c707012dcec6e177ec23ced71",
        "333b09eec4ac455958873ab340198ab2c617f37e8a9dcc3c337a322a80bebad0",
        "51f246d5585b798be78b638651f0a69ff23aa0d66d498dfce58416093ad9b59a"],
}
# the same of the shared constraints at n = 800: rows, cols, vals of each
SHARED_800 = "3b94f6cff3252a7eee9cfa310e5f6da85bc0bdebd3d6c06569132825835dcc33"


@pytest.mark.parametrize("cell", sorted(POOLS))
def test_maxcut_pools_are_pinned(cell):
    _, _, config, mix = harness.load_cell(ROOT, cell)
    for seed, want in enumerate(POOLS[cell]):
        pool = harness.make_pool(config, mix, np.random.default_rng(seed))
        h = hashlib.sha256()
        for inst in pool:
            assert inst.constraints is None and inst.types is None
            assert inst.trace_bound == float(inst.n) and not inst.params
            for a in (inst.C.data, inst.C.indices, inst.C.indptr, inst.b):
                h.update(a.tobytes())
        assert h.hexdigest() == want, (cell, seed)


def test_maxcut_shared_constraints_are_pinned():
    _, _, config, mix = harness.load_cell(ROOT, "maxcut-g1.gset")
    pool = harness.make_pool(config, dict(mix, pool=3),
                             np.random.default_rng(1))
    ops = port.operands(pool)
    assert ops[0] is ops[1] is ops[2] and len(ops[0]) == 800
    h = hashlib.sha256()
    for a in ops[0]:
        for x in (a.rows, a.cols, a.vals):
            h.update(x.tobytes())
    assert h.hexdigest() == SHARED_800


def _fixed(C, seed):
    n = C.shape[0]
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, 10))
    R /= np.linalg.norm(R, axis=1)[:, None]
    R *= 1 + 0.003 * rng.standard_normal((n, 1))
    lam = np.asarray(C.sum(axis=1)).ravel() - 0.5 * rng.random(n)
    return R, lam


# float.hex of each reading, as the references gave them for the same
# instance, R and λ before they took whole instances
READINGS = {
    ("g1", "maxcut"): {"pinfeas": "0x1.815eef0b03b00p-8",
                       "obj": "-0x1.2bbc78ebd7782p+13",
                       "bound": "-0x1.cbef64f8c90efp+13",
                       "gap": "0x1.11a591c5086d7p-1"},
    ("g1", "tf32"): {"pinfeas": "0x1.81de240000000p-8",
                     "obj": "-0x1.2bbc180000000p+13",
                     "bound": "-0x1.cbe2de0000000p+13",
                     "gap": "0x1.119129bcfe8a2p-1"},
    ("torus", "maxcut"): {"pinfeas": "0x1.84f841dd29694p-8",
                          "obj": "-0x1.0311318cfa438p+4",
                          "bound": "-0x1.d107e75eab0bep+8",
                          "gap": "0x1.bb867719a9cabp+4"},
    ("torus", "tf32"): {"pinfeas": "0x1.85a2860000000p-8",
                        "obj": "-0x1.030cac0000000p+4",
                        "bound": "-0x1.d10b180000000p+8",
                        "gap": "0x1.bb91a37c083f9p+4"},
}


@pytest.mark.parametrize("graph,ref", sorted(READINGS))
def test_readings_are_bit_identical(monkeypatch, graph, ref):
    if graph == "g1":
        inst, seed = maxcut.formulation(
            gnp.graph({"n": 800, "density_pct": 6}, 11)), 1
    else:
        # the sparse eigensolver's path, as above n = 4096
        inst, seed = maxcut.formulation(torus.graph({"h": 12, "w": 25},
                                                    4)), 2
        monkeypatch.setattr(maxcut, "DENSE_EIG_MAX_N", 10)
    assert isinstance(inst, Instance)
    R, lam = _fixed(inst.C, seed)
    got = {"maxcut": maxcut.certify,
           "tf32": maxcut.certify_tf32}[ref](inst, R, lam)
    assert {k: float(v).hex() for k, v in got.items()} == \
        READINGS[(graph, ref)]


def test_a_median_limit_reads_the_median_of_its_number():
    rows = [{"gap": 0.1, "bound_over": -1e-3},
            {"gap": 0.2, "bound_over": 2e-4},
            {"gap": 0.3, "bound_over": -2e-3}]
    got = check.read(rows, ["gap", "bound_over", "bound_over_median"])
    assert got == {"gap": 0.3, "bound_over": 2e-4,
                   "bound_over_median": -1e-3}
    # a solve that returned nothing reads +inf in the median too
    rows.append({"gap": None, "bound_over_median": None})
    got = check.read(rows, ["gap", "bound_over_median"])
    assert got["gap"] == float("inf")
    assert got["bound_over_median"] == pytest.approx(-4e-4, rel=1e-12)
    rows += [{"gap": None, "bound_over_median": None}] * 2
    assert check.read(rows, ["bound_over_median"])[
        "bound_over_median"] == float("inf")
