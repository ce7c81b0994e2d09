"""BENCHMARK.json against the benchmark's contract: every cell, configuration,
mix and metric resolves to its files by name; names, units and bounds are
within their limits."""

import copy
import json
import os
import re

import pytest

from portbench import endtoend, harness

ROOT = os.path.dirname(harness.HERE)
MAN = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
PER_LAYER = [m["name"] for m in MAN["per_layer"]]
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|(_dim|_rank)$|expansion|experts_per_tok")


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


def test_paths_and_command():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)


def test_run_seconds_fits_the_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    man, w, config, mix = harness.load_cell(ROOT, cell)
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and one_line(w["why"])
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert os.path.exists(os.path.join(harness.HERE, "families",
                                       f"{config['family']}.py"))
    ref = harness.check.reference(config["problem"])
    assert callable(ref.certify) and callable(ref.certify_tf32)
    assert set(mix) == harness.MIX_KEYS and mix["loop"] == "closed"
    assert mix["pool"] >= 1
    assert harness.load_module("families", config["family"]).graph
    names = {m["name"] for m in harness.metrics_of(MAN["end_to_end"], cell)}
    assert "setup_s" in names and len(names) >= 2
    assert harness.metrics_of(MAN["per_layer"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_limits_name_numbers_the_check_reads(cell):
    config = harness.load_cell(ROOT, cell)[2]
    numbers = set(harness.check.numbers(
        {"pinfeas": 0.0, "gap": 0.0, "obj": 1.0, "bound": 1.0},
        {"obj": 1.0, "pinfeas": 0.0, "bound": 1.0}, config["solver"]))
    for name in harness.check.limits(config):
        base = name.removesuffix(harness.check.MEDIAN)
        assert base in numbers, (cell, name)


def test_configurations():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        config = harness.load_json(os.path.join(ROOT, c["file"]))
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])


def test_metrics():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["name"] in endtoend.METRICS
    layers = {}
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"])
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in {x["name"] for x in
                                  harness.metrics_of(MAN["end_to_end"], cell)}
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_solves_the_same_pool(cell):
    import numpy as np

    _, _, config, mix = harness.load_cell(ROOT, cell)
    mix = dict(mix, pool=3)

    def pool(seed):
        got = harness.make_pool(config, mix, np.random.default_rng(seed))
        return sorted((i.C.nnz, float(abs(i.C).sum()), i.C.data.tobytes())
                      for i in got)

    assert pool(1) == pool(2147483999)


@pytest.mark.parametrize("extra", [{"clients": 4}, {"loop": "open"}])
def test_a_mix_the_harness_does_not_honour_is_refused(extra):
    name = MAN["workloads"][0]["traffic"]
    mix = harness.load_json(os.path.join(harness.HERE, "mixes",
                                         f"{name}.json"))
    harness.check_mix(name, mix)
    with pytest.raises(ValueError, match="closed loop of one client"):
        harness.check_mix(name, dict(mix, **extra))


@pytest.mark.parametrize("name", PER_LAYER)
def test_metric_reader_resolves(name):
    mod = harness.load_module("metrics", name)
    assert callable(mod.read)


# the per-layer metrics that read what every solve path has, and so come
# with every cell; and each MaxCut cell's per-layer metrics as the cells
# reported them when these six still named the two cells
SHARED = {"preprocess_ms", "dual_passes_per_solve", "device_idle_pct",
          "dual_bound_ms", "boundary_ms", "driver_self_ms"}
REPORTED = {
    "maxcut-g81.gset": SHARED | {"host_reads_per_step", "inner_step_ms",
                                 "gather_us", "step_roofline",
                                 "capture_ms"},
    "maxcut-g1.gset": SHARED | {"k1_roofline"},
}


def test_a_new_cell_reports_the_shared_metrics():
    man = copy.deepcopy(MAN)
    new = {"name": "third.cell", "config": MAN["configs"][0]["name"],
           "traffic": "gset.pool64.t10", "chips": 1, "why": "a new cell"}
    man["workloads"].append(new)
    every = {m["name"] for m in man["per_layer"] if "workloads" not in m}
    assert SHARED <= every
    got = {m["name"] for m in harness.metrics_of(man["per_layer"],
                                                 "third.cell")}
    assert got == every
    assert {m["name"] for m in harness.metrics_of(
        man["end_to_end"], "third.cell")} >= {"solve_s", "setup_s"}
    for cell, want in REPORTED.items():
        assert {m["name"] for m in harness.metrics_of(
            man["per_layer"], cell)} == want | every
