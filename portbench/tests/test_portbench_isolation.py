"""What the harness loads: neither JAX nor the JAX package
``sdplrplus_tpu`` (top-level names compared whole: the port
``sdplrplus_tpu_torch`` begins with it), and the reference nothing of the
solver at all. And the run command refuses to run without a card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness, run

ROOT = os.path.dirname(harness.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "sdplrplus_tpu"}

TOP_LEVEL = "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def _top_level_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", f"import json, sys\n{code}\n{TOP_LEVEL}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_solver():
    mods = _top_level_after(
        "import portbench.reference.maxcut, portbench.reference.tf32\n"
        "import portbench.families.gnp, portbench.families.torus\n"
        "import portbench.counts.lbfgs_step, portbench.counts.peaks")
    assert not mods & (FORBIDDEN | {"sdplrplus_tpu_torch", "torch"})


def test_a_run_loads_no_jax():
    mods = _top_level_after(
        "import time\n"
        "from portbench import harness, control, faults, run\n"
        "for m in harness.load_json('BENCHMARK.json')['per_layer']:\n"
        "    harness.load_module('metrics', m['name'])\n"
        "line = harness.run_cell('.', 'maxcut-g1.gset', 3, 0.3, True,\n"
        "    t0=time.time(), device='cpu')\n"
        "assert line['correct'], line\n"
        "assert not run.forbidden_modules()")
    assert "sdplrplus_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    assert run.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "sdplrplus_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfake.x", sys)
    assert not {"sdplrplus_tpu_torch_fake", "jaxfake.x"} & set(
        run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "sdplrplus_tpu.solver", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"sdplrplus_tpu.solver", "jax.numpy"} <= set(
        run.forbidden_modules())


def test_the_command_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal needs one without")
    man = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    out = subprocess.run(
        [*man["command"], "--workload", man["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
