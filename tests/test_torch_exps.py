"""The port's drivers against the JAX package's, on the CPU: the CLI
(``sdplrplus_tpu_torch.exps.run``) for all five problems beside the JAX
package's ``exps/run.py`` on the same instance and flags (objectives to
1e-2, the rounding, the artifacts' keys), the certifier beside the JAX
package's ``exps/certify.py`` on the same artifact, the sweep, the
dual-time A/B, and the measuring entry points' refusal to run without a
card unless asked for the CPU. Instances are the CLI's seeded synthetic
graphs at n = 60 (θ on the cycle power C₆₀², θ = 20: θ of the random
graph takes ~40 s per package on the CPU)."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from sdplrplus_tpu.utils import rounding as j_round
from sdplrplus_tpu_torch import bench
from sdplrplus_tpu_torch.exps import ab_dualtime, bench_micro, certify, run
from sdplrplus_tpu_torch.exps import sweep
from sdplrplus_tpu_torch.exps.common import SHORT_KEYS
from sdplrplus_tpu_torch.models import synthetic_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPS = os.path.join(ROOT, "exps")

SYN = ["--synthetic-n", "60", "--deg", "6"]
CASES = {
    "MaxCut": SYN,
    "MinimumBisection": SYN,
    "CutNorm": SYN,
    "MuConductance": SYN,
    "LovaszTheta": ["--synthetic-kind", "cyclepow", "--synthetic-n", "60",
                    "--deg", "2"],
}
NAME = "SYN60"
TAG = "R-10-seed-0-tol-0.01"


def _jax_script(name):
    """The JAX package's experiment script ``exps/<name>.py`` as a module;
    its persistent JAX cache is not set up (no process-wide config)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_exps_{name}", os.path.join(EXPS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.setup_jax_cache = lambda: None
    return mod


def _jax_cli(monkeypatch, argv):
    mod = _jax_script("run")
    monkeypatch.setattr(sys, "argv", ["run.py"] + argv)
    mod.main()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Each problem through both CLIs, float32, in one output tree per
    package: {problem: (port result, port dir, JAX dir)}."""
    mp = pytest.MonkeyPatch()
    out_t = tmp_path_factory.mktemp("torch")
    out_j = tmp_path_factory.mktemp("jax")
    runs = {}
    try:
        for problem, extra in CASES.items():
            argv = ["--problem", problem, "--graph", NAME, "--dtype",
                    "float32"] + extra
            # the warm-up path on one problem, skipped on the others
            warm = [] if problem == "MaxCut" else ["--skip-warmup"]
            res = run.main(argv + warm + ["--device", "cpu", "--output",
                                          str(out_t)])
            _jax_cli(mp, argv + ["--skip-warmup", "--output", str(out_j)])
            runs[problem] = (res, out_t / problem / NAME,
                             out_j / problem / NAME)
    finally:
        mp.undo()
    return runs


def _load(d, stem):
    with open(d / f"{stem}.json") as f:
        short = json.load(f)
    return short, np.load(d / f"{stem}_state.npz")


@pytest.mark.parametrize("problem", sorted(CASES))
def test_cli_objective_within_1e2_of_the_jax_cli(artifacts, problem):
    res, d_t, d_j = artifacts[problem]
    short_t, _ = _load(d_t, f"SDPLRTORCH-{TAG}")
    short_j, _ = _load(d_j, f"SDPLRTPU-{TAG}")
    assert short_t["obj"] == res["obj"]
    assert abs(short_t["obj"] - short_j["obj"]) \
        <= 1e-2 * abs(short_j["obj"]), (short_t["obj"], short_j["obj"])
    assert short_t["primal_vio"] <= 1e-2
    assert short_t["rel_duality_gap"] <= 1e-2
    assert short_t["dtype"] == "float32"
    assert (short_t["backend"], short_t["device"]) == ("cpu", "cpu")
    assert short_t["power_limit"] is None
    assert short_t["solver"] == "SDPLRPlus-torch"
    if problem == "LovaszTheta":
        assert abs(-short_t["obj"] - 20.0) <= 1e-2 * 20.0


@pytest.mark.parametrize("problem", sorted(CASES))
def test_cli_rounding_equals_the_jax_rounding_of_the_ports_factor(
        artifacts, problem):
    res, _, _ = artifacts[problem]
    A = run.load_graph(run.parse_args(CASES[problem]), NAME, problem)
    if problem == "MaxCut":
        want = j_round.maxcut_rounding(A, res["R"])
        assert 0.0 < want
    elif problem == "MinimumBisection":
        want = j_round.minimum_bisection_rounding(A, res["R"])
    else:
        want = 0.0
    assert res["callback_res"] == want


@pytest.mark.parametrize("problem", sorted(CASES))
def test_cli_artifacts_hold_the_jax_artifacts_keys(artifacts, problem):
    _, d_t, d_j = artifacts[problem]
    short_t, state_t = _load(d_t, f"SDPLRTORCH-{TAG}")
    short_j, state_j = _load(d_j, f"SDPLRTPU-{TAG}")
    assert set(SHORT_KEYS) <= set(short_t)
    assert set(short_j) <= set(short_t)
    assert {"backend", "device", "power_limit"} <= set(short_t)
    assert set(state_j.files) == set(state_t.files)
    for key in state_j.files:
        assert state_t[key].shape == state_j[key].shape, key
    warm = d_t / "SDPLRTORCH-warmup.json"
    assert warm.exists() == (problem == "MaxCut")


def test_certify_equals_the_jax_certifys_arithmetic(artifacts, tmp_path,
                                                     monkeypatch):
    _, d_t, _ = artifacts["MaxCut"]
    art = str(d_t / f"SDPLRTORCH-{TAG}.json")
    argv = ["--problem", "MaxCut", "--graph", NAME, "--artifact", art] + SYN
    mine = certify.main(argv + ["--out", str(tmp_path / "t.json")])
    monkeypatch.setattr(sys, "argv", ["certify.py"] + argv
                        + ["--out", str(tmp_path / "j.json")])
    _jax_script("certify").main()
    with open(tmp_path / "j.json") as f:
        ref = json.load(f)
    for key in ("lam_min_f64", "dual_f64", "rel_duality_gap_f64", "obj",
                "obj_feasible", "trace_bound", "solver_max_dual"):
        assert abs(mine[key] - ref[key]) <= 1e-9 * max(1.0, abs(ref[key])), \
            key
    assert mine["n"] == ref["n"] == 60
    assert mine["solver_device"] == "cpu"
    # no over-certification: the claimed gap is no smaller than float64's
    assert mine["solver_rel_duality_gap"] \
        >= mine["rel_duality_gap_f64"] - 2e-3


def test_cli_multi_device_names_slice_g(tmp_path, monkeypatch):
    """Slice G is in: --devices 2 row-shards the CLI's solve over two gloo
    workers (no NotImplementedError), to the CLI's tolerances, with the
    whole factor in the result."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = run.main(["--device", "cpu", "--devices", "2", "--skip-warmup",
                    "--output", str(tmp_path)] + SYN)
    assert res["devices"] == 2 and "+spmd" in res["inner_engine"]
    assert res["primal_vio"] <= 1e-2 and res["rel_duality_gap"] <= 1e-2
    assert np.asarray(res["R"]).shape[0] == 60


def test_sweep_writes_both_artifacts(tmp_path, capsys):
    rc = sweep.main(["--problems", "MaxCut", "CutNorm", "--device", "cpu",
                     "--output", str(tmp_path)] + SYN)
    out = capsys.readouterr().out
    assert rc == 0, out
    for problem in ("MaxCut", "CutNorm"):
        d = tmp_path / problem / "SYN60"
        assert (d / f"SDPLRTORCH-{TAG}.json").exists()
        assert (d / f"SDPLRTORCH-{TAG}_state.npz").exists()
        assert f"[{problem}/SYN60] obj=" in out and "OK" in out
    assert "sweep done; 0 failure(s)" in out


def test_ab_dualtime_drivers_take_the_same_iterations(tmp_path):
    out = ab_dualtime.main(["--n", "60", "--deg", "6", "--dtype", "float64",
                            "--device", "cpu", "--out",
                            str(tmp_path / "ab.json")])
    assert out["trajectory_matched"]
    assert out["fused"]["iter"] == out["host"]["iter"] > 0
    assert out["fused"]["dual_time_estimated"]
    assert not out["host"]["dual_time_estimated"]
    assert out["device"] == "cpu"
    assert (tmp_path / "ab.json").exists()


@pytest.mark.parametrize("entry", ["bench", "bench_micro", "ab_dualtime",
                                   "run"])
def test_measuring_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"bench": bench.main, "bench_micro": bench_micro.main,
            "ab_dualtime": ab_dualtime.main,
            "run": lambda argv: run.main(argv + SYN + ["--skip-warmup"])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main[entry]([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench(synthetic_graph(60, 6))


def test_bench_runs_its_control_flow_on_the_cpu():
    d = bench.run_bench(synthetic_graph(60, 6), label="SYN60",
                        device="cpu", steps=(2, 12), repeats=1)
    assert d["inner_engine"] == "megakernel-plain"
    assert d["device_al_iters_per_sec"] > 0
    assert d["rel_duality_gap"] <= 1e-2 and d["primal_vio"] <= 1e-2
    assert (d["backend"], d["device"]) == ("cpu", "cpu")
    # the fused driver's dual time is modelled, and named so
    assert d["dual_time_modelled_s"] >= 0 and d["primal_time_modelled_s"] > 0
    assert "dual_time_measured_s" not in d and "dual_time_s" not in d
    base = bench.cpu_baseline()
    assert base["graph"] == "RND20000d16" and base["n"] == 20000
    assert abs(base["totaltime"] - 35.66) < 0.01


def test_bench_micro_times_each_operator_on_the_cpu(capsys):
    rows = bench_micro.main(["--device", "cpu", "--synthetic-n", "300",
                             "--deg", "8", "--iters", "2"])
    names = [r["op"] for r in rows]
    assert names == ["A_uu", "A_linesearch", "gradient (dense C)",
                     "lbfgs_direction"]
    for r in rows:
        assert r["issue_us"] > 0 and r["bound_us"] > 0
        assert r["issue_timer"].startswith("host clock")
        assert r["device_us"] is None and r["share_of_bound"] is None
    assert capsys.readouterr().out.count("[micro]") == 4


# ---- the study scripts and the scaling driver ------------------------------

def test_rank_mode_study_runs_both_modes(tmp_path):
    """Warm and restart rank doubling on θ of C₄₈² (θ = 16) through the
    CLI's run_one: both reach θ within 1e-2 and pinfeas ≤ 1e-2 on the
    entry-mask engine, and the summary JSON holds both rows."""
    from sdplrplus_tpu_torch.exps import rank_mode_study

    rows = rank_mode_study.main(["--graphs", "cyclepow:48:2", "--device",
                                 "cpu", "--output", str(tmp_path),
                                 "--maxtime", "120"])
    assert [r["mode"] for r in rows] == ["warm", "restart"]
    for r in rows:
        assert abs(-r["obj"] - 16.0) <= 16.0 * 1e-2, r
        assert r["primal_vio"] <= 1e-2 and r["inner_engine"] == \
            "entry-mask-torch", r
        assert r["graph"] == "cyclepow-48-2" and r["iter"] > 0
    with open(tmp_path / "rank_mode_study_LovaszTheta.json") as f:
        assert json.load(f) == rows


def test_diag_mucond_bounds_and_the_jax_dense_bound():
    """The three μ-conductance bounds at the final iterate of a float64
    solve on SYN60: all finite, the solver's least-squares bound (b) at
    least the AL-iterate one (a) less 1e-9, every bound below the
    objective plus 1e-9 (weak duality); and ``dual_value_mucond`` equal
    to the JAX package's exps/diag_mucond.py on the same inputs (1e-10)."""
    from sdplrplus_tpu_torch.exps import diag_mucond
    from sdplrplus_tpu_torch.models.problems import _laplacian

    out = diag_mucond.main(["--synthetic-n", "60", "--deg", "6",
                            "--maxtime", "30", "--device", "cpu",
                            "--dtype", "float64"])
    for tag in ("a", "b", "c"):
        assert np.isfinite(out[f"dual_{tag}"])
        assert out[f"dual_{tag}"] <= out["obj"] + 1e-9
    assert out["dual_b"] >= out["dual_a"] - 1e-9

    A = synthetic_graph(60, 6)
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    vol = float(d.sum())
    R = np.random.default_rng(3).normal(size=(60, 4))
    mine = diag_mucond.dual_value_mucond(_laplacian(A), d, vol, 0.1, R, 7.0)
    theirs = _jax_script("diag_mucond").dual_value_mucond(
        _laplacian(A), d, vol, 0.1, R, 7.0)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def test_scaling_comms_words_match_the_jax_compile():
    """exps.scaling --no-time at n = 64: a row per (kind, nd, layout),
    the halo row only where the compile carries halo metadata, and the
    words per pass (n_pad − n_loc)·r and (nd − 1)·H·r from the JAX
    package's compile of the same instance (the JAX package's
    exps/scaling.py formulas)."""
    from sdplrplus_tpu import SDPProblem as JProblem
    from sdplrplus_tpu.compile import compile_problem as j_compile
    from sdplrplus_tpu.models import maxcut as j_maxcut
    from sdplrplus_tpu_torch.exps import scaling
    from sdplrplus_tpu_torch.models import synthetic_local_graph

    out = scaling.main(["--n", "64", "--deg", "6", "--no-time", "--device",
                        "cpu", "--out", os.devnull])
    graphs = {"random": synthetic_graph(64, 6),
              "local": synthetic_local_graph(64, 6, 32)}
    seen = set()
    for row in out["rows"]:
        nd, r = row["nd"], 10
        C, As, b = j_maxcut(graphs[row["kind"]])[:3]
        pad = int(np.lcm(128, nd))
        cp = j_compile(JProblem(C, list(As), np.asarray(b, float), None),
                       n_shards=nd, row_pad=pad, nnz_pad=pad, dense=False)
        if nd == 1:
            want = 0
        elif row["layout"] == "halo":
            want = (nd - 1) * cp.halo_H * r
        else:
            want = (cp.n_pad - cp.n_pad // nd) * r
        assert row["comms_words_per_pass_per_device"] == want, row
        assert row["per_step_s"] is None
        seen.add((row["kind"], nd, row["layout"]))
    assert {(k, nd, "allgather") for k in graphs for nd in (1, 2, 4, 8)} \
        <= seen
    assert ("local", 2, "halo") in seen


def test_scaling_times_two_gloo_ranks(monkeypatch):
    """exps.scaling times the sharded fused driver at 2 gloo ranks on the
    CPU (spawned workers), with the all-gather and with the halo: finite
    seconds per inner step over the step budget."""
    from sdplrplus_tpu_torch.exps import scaling

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for halo in (False, True):
        per_step, steps = scaling.time_world(2, "cpu", dict(
            kind="local", n=64, deg=6, window=32, r=10, steps=3,
            halo=halo))
        assert steps == 3 and 0 < per_step < 10, (halo, per_step)
