"""The PyTorch/CUDA package stands alone.

``sdplrplus_tpu_torch`` imports neither JAX nor the JAX package, its
entry points run on the card unless the caller asks for the CPU, and its
``SolverConfig`` carries the JAX package's knobs and defaults plus
``device``. The JAX package's config module is executed from its source
file on its own (it imports nothing of JAX at module level), so this file
never imports JAX either.
"""

import dataclasses
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sdplrplus_tpu_torch")


def _jax_config_module():
    return runpy.run_path(os.path.join(ROOT, "sdplrplus_tpu", "config.py"))


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys, sdplrplus_tpu_torch, sdplrplus_tpu_torch.convert, "
        "sdplrplus_tpu_torch.ops.megakernel, sdplrplus_tpu_torch.solver.outer, "
        "sdplrplus_tpu_torch.solver.major, sdplrplus_tpu_torch.probes, "
        "sdplrplus_tpu_torch.ops.gather, sdplrplus_tpu_torch.ops.blocklanczos, "
        "sdplrplus_tpu_torch.adapter, sdplrplus_tpu_torch.utils.checkpoint, "
        "sdplrplus_tpu_torch.exps.run, sdplrplus_tpu_torch.exps.sweep, "
        "sdplrplus_tpu_torch.exps.certify, "
        "sdplrplus_tpu_torch.exps.bench_micro, "
        "sdplrplus_tpu_torch.exps.ab_dualtime, sdplrplus_tpu_torch.bench, "
        "sdplrplus_tpu_torch.utils.io, sdplrplus_tpu_torch.utils.writers, "
        "sdplrplus_tpu_torch.utils.rounding, "
        "sdplrplus_tpu_torch.utils.perfprofile, "
        "sdplrplus_tpu_torch.utils.cache\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'sdplrplus_tpu' "
        "or m.startswith('sdplrplus_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_file_imports_jax_or_the_jax_package():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|sdplrplus_tpu)(\.|\s|$)|"
        r"#\s*include\s*[<\"](jax|sdplrplus_tpu)")
    sources = []
    for d, _, files in os.walk(PKG):
        sources += [os.path.join(d, f) for f in files
                    if f.endswith((".py", ".cu", ".cuh"))]
    sources += [os.path.join(ROOT, "chip_smoke.py"),
                os.path.join(ROOT, "tests", "test_torch_cuda.py")]
    assert any(s.endswith("megakernel.cu") for s in sources)
    assert any(s.endswith("megakernel_armijo.cu") for s in sources)
    assert any(s.endswith("gather.cu") for s in sources)
    assert any(s.endswith("probes.py") for s in sources)
    for name in ("run.py", "sweep.py", "certify.py", "bench_micro.py",
                 "ab_dualtime.py", "bench.py", "io.py", "writers.py",
                 "rounding.py", "perfprofile.py", "cache.py"):
        assert any(s.endswith(os.sep + name) for s in sources), name
    for path in sources:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.search(line), f"{path}:{i}: {line.strip()}"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from sdplrplus_tpu_torch import SolverConfig, sdplr
    from sdplrplus_tpu_torch.models import maxcut
    import scipy.sparse as sp

    assert SolverConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    C, As, b = maxcut(sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 0.0]])))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sdplr(C, As, b, 1, printlevel=0)


def test_config_fields_and_defaults_match_the_jax_package():
    from sdplrplus_tpu_torch import SolverConfig

    jax_cfg = _jax_config_module()["SolverConfig"]
    mine = {f.name: f for f in dataclasses.fields(SolverConfig)}
    ref = {f.name: f for f in dataclasses.fields(jax_cfg)}
    assert set(mine) - set(ref) == {"device"}
    assert set(ref) <= set(mine)
    a, b = SolverConfig(), jax_cfg()
    for name in ref:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("bad", [
    {"lbfgs_impl": "dense"}, {"rank_update_mode": "cold"},
    {"inner_impl": "pallas"}, {"no_such_knob": 1},
])
def test_copy_with_rejects_what_the_jax_package_rejects(bad):
    from sdplrplus_tpu_torch import SolverConfig

    jax_cfg = _jax_config_module()["SolverConfig"]
    with pytest.raises(ValueError):
        jax_cfg().copy_with(**bad)
    with pytest.raises(ValueError):
        SolverConfig().copy_with(**bad)


def test_resolve_dtype_maps_to_torch_without_side_effects():
    from sdplrplus_tpu_torch.config import SolverConfig, resolve_dtype

    before = torch.get_default_dtype()
    assert resolve_dtype(SolverConfig()) == torch.float32
    assert resolve_dtype(SolverConfig(dtype="float64")) == torch.float64
    assert resolve_dtype(SolverConfig(dtype="float32")) == torch.float32
    assert torch.get_default_dtype() == before
    with pytest.raises(ValueError):
        resolve_dtype(SolverConfig(dtype="bfloat16"))


def test_unported_options_name_their_slice(monkeypatch):
    """Nothing is left unported: multi-device solving (ROADMAP slice G)
    runs, as fused_outer=False, checkpoint_path and profile_dir do
    (tests/test_torch_host.py). devices=2 on the CPU solves K₂ MaxCut on
    two gloo workers (obj −1) and raises no NotImplementedError."""
    from sdplrplus_tpu_torch import sdplr
    from sdplrplus_tpu_torch.models import maxcut
    import scipy.sparse as sp

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    C, As, b = maxcut(sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 0.0]])))
    res = sdplr(C, As, b, 1, printlevel=0, device="cpu", devices=2,
                dtype="float64", ptol=1e-8, objtol=1e-8,
                prior_trace_bound=2.0)
    assert res["devices"] == 2 and "+spmd" in res["inner_engine"]
    assert abs(res["obj"] + 1.0) < 1e-6


def test_off_diagonal_constraints_name_the_general_engine_slice():
    """Lovász θ without the entry-mask engine has off-diagonal constraint
    entries: it runs on the general engine (ROADMAP slice E), and 100
    iterations in float64 follow the JAX package's xla-general solve on
    the same input and seed (the same iterations and major iterations, R
    to 1e-9, the objective to 1e-10 relative; the dual bounds, from
    different Lanczos start vectors, to 1e-2). The reference's general
    path does not converge θ (ROADMAP F6), so the trajectory is held, not
    convergence."""
    from sdplrplus_tpu import sdplr as j_sdplr
    from sdplrplus_tpu.models import problems as j_models
    from sdplrplus_tpu_torch import sdplr
    from sdplrplus_tpu_torch.models import lovasz_theta, make_random_graph
    from sdplrplus_tpu_torch.solver.outer import ENGINE_GENERAL

    A = make_random_graph(12, 0.5, seed=1)
    kw = dict(printlevel=0, entry_mode=False, dtype="float64", maxiter=100,
              prior_trace_bound=1.0)
    ref = j_sdplr(*j_models.lovasz_theta(A), 2, **kw)
    res = sdplr(*lovasz_theta(A), 2, device="cpu", **kw)
    assert (ref["inner_engine"], res["inner_engine"]) == ("xla-general",
                                                          ENGINE_GENERAL)
    assert res["iter"] == ref["iter"] and res["majoriter"] == ref["majoriter"]
    np.testing.assert_allclose(res["R"], ref["R"], rtol=1e-9, atol=1e-9)
    assert abs(res["obj"] - ref["obj"]) <= 1e-10 * abs(ref["obj"])
    assert abs(res["max_dual_value"] - ref["max_dual_value"]) \
        <= 1e-2 * abs(ref["max_dual_value"])
