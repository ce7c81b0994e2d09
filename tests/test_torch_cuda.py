"""K1 on the card: the CUDA kernel against its plain version, and a solve
served by it. Every test here needs an H100 and nvcc (marker ``cuda``)
and skips elsewhere. The file imports no JAX, so it runs on a machine
that has only PyTorch (``--noconftest``: tests/conftest.py sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.compile import compile_problem
from sdplrplus_tpu_torch.models import problems
from sdplrplus_tpu_torch.ops import megakernel as mk
from sdplrplus_tpu_torch.ops.device import to_device
from sdplrplus_tpu_torch.problem import SDPProblem
from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init
from sdplrplus_tpu_torch.solver.outer import ENGINE_KERNEL

FAMILIES = ("maxcut", "minimum_bisection", "cutnorm")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture
def h100():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100) and nvcc")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("K1 is built for sm_90a (H100)")


def _run_on(device, problem, dtype, steps, n=200, r=10, k=4, seed=0):
    A = problems.make_random_graph(n, 0.5, seed=seed)
    C, As, b = getattr(problems, problem)(A)
    dp = to_device(compile_problem(SDPProblem(C, As, np.asarray(b, float),
                                              None), dense=True),
                   dtype, device)
    meta, data = mk.prepare_mega_data(dp, k=k, gtol_relative=True,
                                      ptol_relative=True)
    spec = mk.mega_spec_for(meta, r)
    rng = np.random.default_rng(seed + 1)
    R0 = np.zeros((dp.n_pad, r))
    R0[:n] = rng.uniform(-1, 1, (n, r))
    lam = 0.1 * rng.standard_normal(dp.m)
    t = lambda x: torch.tensor(x, dtype=dtype, device=device)
    # stagnation off (-inf): the comparison is at a fixed step count
    return mk.mega_chunk(spec, r, meta["m"], meta["pscale"], data, t(R0),
                         lbfgs_init(k, dp.n_pad, r, dtype, device), t(lam),
                         t(2.0), 1e-12, float("-inf"), steps)


@pytest.mark.cuda
@pytest.mark.parametrize("problem", FAMILIES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_matches_its_plain_version(h100, problem, dtype):
    td = DTYPES[dtype]
    before = mk.K1.launches
    ck, vk = _run_on("cuda", problem, td, 25)
    torch.cuda.synchronize()
    assert mk.K1.launches == before + 1
    cp, vp = _run_on("cpu", problem, td, 25)
    tol = 3e-3 if dtype == "float32" else 1e-9
    assert ck.steps == cp.steps == 25
    as_np = lambda x: x.detach().cpu().double().numpy()
    np.testing.assert_allclose(as_np(ck.R), as_np(cp.R), rtol=tol, atol=tol)
    np.testing.assert_allclose(as_np(ck.vio_raw), as_np(cp.vio_raw),
                               rtol=tol, atol=tol)
    assert abs(float(vk) - float(vp)) < tol * 10


@pytest.mark.cuda
def test_solve_on_the_card_runs_the_kernel(h100):
    A = problems.make_random_graph(200, 0.5, seed=1)
    C, As, b = problems.maxcut(A)
    before = mk.K1.launches
    res = sdplr(C, As, b, 10, ptol=1e-2, objtol=1e-2,
                prior_trace_bound=200.0, dtype="float32", seed=0,
                printlevel=0)
    assert res["inner_engine"] == ENGINE_KERNEL
    assert mk.K1.launches > before
    assert res["primal_vio"] <= 1e-2 and res["rel_duality_gap"] <= 1e-2
    ref = sdplr(C, As, b, 10, ptol=1e-2, objtol=1e-2,
                prior_trace_bound=200.0, dtype="float32", seed=0,
                printlevel=0, device="cpu")
    assert abs(res["obj"] - ref["obj"]) <= 1e-2 * abs(ref["obj"])
