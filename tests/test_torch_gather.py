"""The gather kernels' plain versions against the Pallas probe kernels.

Each of the eight Pallas gather probes of the JAX package's experiments
(exps/probe2.py, probe3.py, probe5.py, probe_gather.py) runs in TPU
interpret mode on the CPU, and the port's counterpart in
sdplrplus_tpu_torch/probes.py (the plain versions of ops/gather.py on a
CPU tensor) gets the same numpy inputs. A gather is exact, so the
tolerance is equality. The port's ELL SpMM, whose row gather is
``gather_rows``, is held against the JAX package's ``spmm_C`` and
``spmm_ell``. The CUDA kernels themselves run in tests/test_torch_cuda.py
on the card.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdplrplus_tpu.compile import compile_problem as j_compile
from sdplrplus_tpu.models.problems import maxcut as j_maxcut
from sdplrplus_tpu.ops.device import to_device as j_to_device
from sdplrplus_tpu.ops.spmm import spmm_C as j_spmm_C, spmm_ell as j_spmm_ell
from sdplrplus_tpu.problem import SDPProblem as JProblem
from sdplrplus_tpu_torch import probes
from sdplrplus_tpu_torch.compile import compile_problem
from sdplrplus_tpu_torch.models import maxcut, synthetic_graph
from sdplrplus_tpu_torch.ops import gather
from sdplrplus_tpu_torch.ops.device import to_device
from sdplrplus_tpu_torch.ops.spmm import spmm_C, spmm_ell
from sdplrplus_tpu_torch.problem import SDPProblem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(ROOT, "exps", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probe2():
    return _probe("probe2")


@pytest.fixture(scope="module")
def probe3():
    return _probe("probe3")


@pytest.fixture(scope="module")
def probe5():
    return _probe("probe5")


@pytest.fixture(scope="module")
def probe_gather():
    return _probe("probe_gather")


def _interpret(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args))


def _X(rows, r, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (rows, r)).astype(np.float32)


def _ids(hi, size, seed=1):
    return np.random.default_rng(seed).integers(0, hi, size).astype(
        np.int32)


def _same(got: torch.Tensor, want: np.ndarray):
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_take_matches_pallas(probe3):
    """P1: exps/probe3.py::_full_take_call."""
    X, idx = _X(2048, 16), _ids(2048, 1024)
    want = _interpret(probe3._full_take_call, jnp.asarray(X),
                      jnp.asarray(idx), 16)
    _same(probes.full_take_call(torch.tensor(X), torch.tensor(idx), 16), want)


@pytest.mark.parametrize("rows,r", [(128, 16), (1024, 16), (128, 128)])
def test_sublane_take_matches_pallas(probe3, rows, r):
    """P2: exps/probe3.py::_sublane_take_call on one (rows, r) tile."""
    X, idx = _X(rows, r), _ids(rows, 512)
    want = _interpret(probe3._sublane_take_call, jnp.asarray(X),
                      jnp.asarray(idx), rows, 512, r)
    _same(probes.sublane_take_call(torch.tensor(X), torch.tensor(idx), rows,
                                   512, r), want)


def test_pallas_take_matches_pallas(probe_gather, monkeypatch):
    """P3: exps/probe_gather.py::_pallas_take_call (its output shape reads
    the module's T)."""
    monkeypatch.setattr(probe_gather, "T", 1024)
    X, idx = _X(2048, 32), _ids(2048, 1024)
    want = _interpret(probe_gather._pallas_take_call, jnp.asarray(X),
                      jnp.asarray(idx), 32)
    _same(probes.pallas_take_call(torch.tensor(X), torch.tensor(idx), 32),
          want)


@pytest.mark.parametrize("nslot,rpd", [(8, 1), (4, 1), (8, 8)])
def test_dma_gather_matches_pallas(probe5, nslot, rpd):
    """P4: exps/probe5.py::_dma_gather, q = rows_per_dma rows per index."""
    X = _X(2048, 16)
    idx = _ids(2048 // rpd, 1024)
    want = _interpret(probe5._dma_gather, jnp.asarray(X), jnp.asarray(idx),
                      16, nslot, rpd)
    _same(probes.dma_gather(torch.tensor(X), torch.tensor(idx), 16, nslot,
                            rpd), want)


@pytest.mark.parametrize("span,bucket", [(128, 512), (1024, 512),
                                         (128, 128)])
def test_onehot_matches_pallas(probe2, span, bucket):
    """P5: exps/probe2.py::_onehot_call (a one-hot MXU select in a window;
    on 0/1 weights the float32 product is exact)."""
    X = _X(2048, 16)
    nt = 2
    wins, offs = _ids(2048 // span, nt), _ids(span, (nt, bucket), seed=2)
    want = _interpret(probe2._onehot_call, jnp.asarray(X), jnp.asarray(wins),
                      jnp.asarray(offs), 16, span, bucket)
    _same(probes.onehot_call(torch.tensor(X), torch.tensor(wins),
                             torch.tensor(offs), 16, span, bucket), want)


def test_pallas_onehot_matches_pallas(probe_gather, monkeypatch):
    """P6: exps/probe_gather.py::_pallas_onehot_call (span 128, tiles of
    TT = 512; its tile count reads the module's T)."""
    monkeypatch.setattr(probe_gather, "T", 1024)
    X = _X(2048, 16)
    wins, offs = _ids(2048 // 128, 2), _ids(128, 1024, seed=2)
    want = _interpret(probe_gather._pallas_onehot_call, jnp.asarray(X),
                      jnp.asarray(wins), jnp.asarray(offs), 16)
    _same(probes.pallas_onehot_call(torch.tensor(X), torch.tensor(wins),
                                    torch.tensor(offs), 16), want)


@pytest.mark.parametrize("sub,lanes", [(8, 128), (32, 1024), (16, 512)])
def test_lane_gather_matches_pallas(probe3, sub, lanes):
    """P7: exps/probe3.py::_lane_gather_call on one (sub, lanes) tile."""
    X, idx = _X(sub, lanes), _ids(lanes, (sub, lanes))
    want = _interpret(probe3._lane_gather_call, jnp.asarray(X),
                      jnp.asarray(idx), sub, lanes)
    _same(probes.lane_gather_call(torch.tensor(X), torch.tensor(idx), sub,
                                  lanes), want)


def test_lane_gather_grid_matches_pallas(probe3):
    """P8: exps/probe3.py::_lane_gather_grid over row tiles."""
    sub, lanes, ntiles = 8, 128, 4
    X, idx = _X(sub * ntiles, lanes), _ids(lanes, (sub * ntiles, lanes))
    want = _interpret(probe3._lane_gather_grid, jnp.asarray(X),
                      jnp.asarray(idx), sub, lanes, ntiles)
    _same(probes.lane_gather_grid(torch.tensor(X), torch.tensor(idx), sub,
                                  lanes, ntiles), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("r", [10, 20])
def test_plain_versions_on_the_cpu(dtype, idx_dtype, r):
    """On a CPU tensor each wrapper is its plain version: rows of any width,
    either float and index type, no launch counted."""
    g = torch.Generator().manual_seed(r)
    X = torch.randn((300, r), generator=g, dtype=dtype)
    idx = torch.randint(0, 300, (500,), generator=g).to(idx_dtype)
    before = [k.launches for k in gather.KERNELS]
    Xn = X.numpy()
    np.testing.assert_array_equal(gather.gather_rows(X, idx).numpy(),
                                  Xn[idx.numpy()])
    q4 = torch.randint(0, 75, (40,), generator=g).to(idx_dtype)
    rows = (q4.numpy()[:, None] * 4 + np.arange(4)).reshape(-1)
    np.testing.assert_array_equal(gather.gather_rows(X, q4, 4).numpy(),
                                  Xn[rows])
    wins = torch.randint(0, 3, (5,), generator=g).to(idx_dtype)
    offs = torch.randint(0, 100, (5, 8), generator=g).to(idx_dtype)
    rows = np.repeat(wins.numpy(), 8) * 100 + offs.numpy().reshape(-1)
    np.testing.assert_array_equal(
        gather.gather_window(X, wins, offs, 100, 8).numpy(), Xn[rows])
    li = torch.randint(0, r, (300, r), generator=g).to(idx_dtype)
    np.testing.assert_array_equal(gather.gather_lanes(X, li).numpy(),
                                  np.take_along_axis(Xn, li.numpy(), 1))
    assert [k.launches for k in gather.KERNELS] == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernel path takes only CUDA tensors of the right types; the
    checks run before anything is built or launched."""
    X = torch.zeros((4, 3))
    i = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        gather._check("gather_rows", X, i)
    with pytest.raises(ValueError, match="rows_per_index"):
        gather.gather_rows(X, i, 0)


def test_cuda_library_raises_on_an_error_code(monkeypatch):
    """utils/build.CudaLibrary, which loads every kernel library of the
    port: entry points typed at first use, ``on_load`` run once, and a
    non-zero return turned into a RuntimeError carrying the library's
    message. The C library stands in for a built csrc library (``abs``
    as an entry point, ``strerror`` as the error-string function)."""
    import ctypes
    import ctypes.util

    from sdplrplus_tpu_torch.utils import build

    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    monkeypatch.setattr(build, "build_cuda",
                        lambda src: build.Built(libc, src, "", 0.0, True))
    loaded = []
    lib = build.CudaLibrary("stand_in.cu", {"abs": [ctypes.c_int]},
                            "strerror", on_load=loaded.append)
    lib.call("abs", 0)
    with pytest.raises(RuntimeError, match="abs launch failed: CUDA error 2"):
        lib.call("abs", -2, what="abs launch")
    assert loaded == [libc] and lib.built.path == "stand_in.cu"


def _both_spmm(n, deg, r, seed=0):
    A = synthetic_graph(n, deg, seed=1)
    C, As, b = maxcut(A)
    tdp = to_device(compile_problem(SDPProblem(C, As, np.asarray(b, float),
                                               None), dense=False),
                    torch.float64, "cpu")
    jC, jAs, jb = j_maxcut(A)[:3]
    jdp = j_to_device(j_compile(JProblem(jC, list(jAs), np.asarray(jb, float),
                                         None), dense=False), jnp.float64)
    X = np.random.default_rng(seed).standard_normal((tdp.n_pad, r))
    return tdp, jdp, X


@pytest.mark.parametrize("r", [10, 20])
def test_spmm_C_matches_the_jax_package(r):
    """C_sparse @ X through the two-tier ELL layout, whose row gather is
    gather_rows' plain version on the CPU, against the JAX package's
    spmm_C, in float64 (a graph with a heavy tail so tier 2 is used)."""
    tdp, jdp, X = _both_spmm(600, 16, r)
    assert tdp.has_ell2 and tdp.ell2_rows.shape[0] > 0
    got = spmm_C(tdp, torch.tensor(X)).numpy()
    want = np.asarray(j_spmm_C(jdp, jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_spmm_ell_matches_the_jax_package():
    tdp, jdp, X = _both_spmm(400, 12, 10, seed=3)
    got = spmm_ell(torch.tensor(X), tdp.ell_cols, tdp.cell_val,
                   tdp.ell2_rows, tdp.ell2_cols, tdp.cell2_val).numpy()
    want = np.asarray(j_spmm_ell(jnp.asarray(X), jdp.ell_cols, jdp.cell_val,
                                 jdp.ell2_rows, jdp.ell2_cols, jdp.cell2_val))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    tier1 = spmm_ell(torch.tensor(X), tdp.ell_cols, tdp.cell_val).numpy()
    want1 = np.asarray(j_spmm_ell(jnp.asarray(X), jdp.ell_cols,
                                  jdp.cell_val))
    np.testing.assert_allclose(tier1, want1, rtol=1e-12, atol=1e-12)
