"""K2, the Armijo inner-loop megakernel: its plain version against the
JAX package's Pallas kernel ``_make_kernel_armijo`` run in interpret mode,
and against the JAX package's XLA Armijo inner loop in the compact L-BFGS
form, which K2 and its plain version follow.

On the CPU ``mega_chunk`` runs ``mega_chunk_armijo_plain``, K2's loop
written step by step in torch; the CUDA kernel itself only runs on an
H100 (tests/test_torch_cuda.py, which imports no JAX). The problems are
μ-conductance with native inequalities (three diagonal channels per row,
one wide and one low-rank constraint, sparse C densified for the kernel)
and relaxed MaxCut with native inequalities (one channel, dense C), from
states at the feasible region's scale (tests/test_torch_armijo.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdplrplus_tpu.ops.megakernel import make_mega_inner_chunk
from sdplrplus_tpu.solver.al import al_value_grad as j_al_value_grad
from sdplrplus_tpu.solver.inner import inner_chunk as j_inner_chunk
from sdplrplus_tpu.solver.lbfgs import lbfgs_init as j_lbfgs_init

from sdplrplus_tpu_torch.ops import megakernel as mk
from sdplrplus_tpu_torch.solver.lbfgs import lbfgs_init as t_lbfgs_init

from test_torch_armijo import setup_case

DT = {"float32": (jnp.float32, torch.float32),
      "float64": (jnp.float64, torch.float64)}
FAMILIES = ("mucond", "relaxed_ineq_dense")


def _both(case, dtype, k, r=4):
    """The JAX kernel's runner (interpret mode) and the port's, with the
    start state (R, λ) as numpy arrays."""
    jd, td = DT[dtype]
    dp_j, dp_t, R0, lam = setup_case(case, r=r, dtypes=(jd, td))
    run_j = make_mega_inner_chunk(dp_j, k=k, gtol_relative=True,
                                  ptol_relative=True, interpret=True)(r)
    meta, data = mk.prepare_mega_data(dp_t, k=k, gtol_relative=True,
                                      ptol_relative=True)
    spec = mk.mega_spec_for(meta, r)
    assert spec.armijo and mk.megakernel_eligible(dp_t, r, k, True, td)

    def j_run(R, lam_, gtol, stag, steps, lbfgs=None):
        lb = lbfgs if lbfgs is not None else j_lbfgs_init(max(k, 1),
                                                          dp_j.n_pad, r, jd)
        return run_j(jnp.asarray(R, jd), lb, jnp.asarray(lam_, jd),
                     jnp.asarray(2.0, jd), jnp.asarray(gtol, jd),
                     jnp.asarray(stag, jd), jnp.asarray(steps, jnp.int32))

    def t_run(R, lam_, gtol, stag, steps, lbfgs=None):
        lb = lbfgs if lbfgs is not None else t_lbfgs_init(max(k, 1),
                                                          dp_t.n_pad, r, td)
        return mk.mega_chunk(spec, r, meta["m"], meta["pscale"], data,
                             torch.as_tensor(np.asarray(R), dtype=td), lb,
                             torch.as_tensor(np.asarray(lam_), dtype=td),
                             torch.tensor(2.0, dtype=td), gtol, stag, steps)

    return dp_j, dp_t, spec, j_run, t_run, R0, lam


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("case", FAMILIES)
def test_entry_state_matches_the_sharp_al_oracle(case):
    """K2 recomputes (L, G, vio) from R on entry; with no step they equal
    the JAX package's sharp-AL fg! (the analog of
    tests/test_megakernel.py:182-222, in float64)."""
    dp_j, _, _, j_run, t_run, R0, lam = _both(case, "float64", 4)
    L, vio_raw, G, y_full, gn, _ = j_al_value_grad(
        dp_j, jnp.asarray(R0), jnp.asarray(lam), jnp.asarray(2.0), True, True)
    ct, _ = t_run(R0, lam, 0.0, -np.inf, 0)
    cj, _ = j_run(R0, lam, 0.0, -np.inf, 0)
    assert ct.steps == 0
    for got, want, name in ((ct.L_val, L, "L"), (ct.vio_raw, vio_raw, "vio"),
                            (ct.G, G, "G"), (ct.y_full, y_full, "y"),
                            (ct.grad_norm, gn, "gnorm")):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(_np(ct.vio_raw), np.asarray(cj.vio_raw),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", FAMILIES)
@pytest.mark.parametrize("steps", [1, 25])
def test_plain_version_matches_the_compact_xla_loop(case, steps):
    """K2's plain version (the compact direction on Grams built from the
    ring at entry and refreshed on every push) against the JAX package's
    XLA Armijo inner loop with ``lbfgs_compact=True`` in float64, k = 4;
    the Grams it returns equal those ``lbfgs_push`` kept."""
    k = 4
    dp_j, _, _, _, t_run, R0, lam = _both(case, "float64", k)
    r = R0.shape[1]
    f = lambda x: jnp.asarray(x, jnp.float64)
    L0, vio0, G0, y0, gn0, _ = j_al_value_grad(dp_j, f(R0), f(lam), f(2.0),
                                               True, True)
    cj, vj = j_inner_chunk(
        dp_j, f(R0), G0, y0, vio0, L0, gn0,
        j_lbfgs_init(k, dp_j.n_pad, r, jnp.float64), f(lam), f(2.0),
        f(1e-12), f(-np.inf), steps, k=k, use_armijo=True,
        gtol_relative=True, ptol_relative=True, lbfgs_compact=True)
    ct, vt = t_run(R0, lam, 1e-12, -np.inf, steps)
    assert ct.steps == int(cj.steps) == steps
    assert ct.stagnated == bool(cj.stagnated)
    tol = 1e-9
    for name in ("R", "G", "vio_raw", "y_full", "L_val", "grad_norm"):
        np.testing.assert_allclose(_np(getattr(ct, name)),
                                   _np(getattr(cj, name)), rtol=tol,
                                   atol=tol, err_msg=f"{name} after {steps}")
    for name in ("s_hist", "y_hist", "rho", "sty", "yty"):
        np.testing.assert_allclose(_np(getattr(ct.lbfgs, name)),
                                   _np(getattr(cj.lbfgs, name)), rtol=tol,
                                   atol=tol, err_msg=name)
    assert ct.lbfgs.head == int(cj.lbfgs.head)
    assert abs(float(vt) - float(vj)) < tol


@pytest.mark.parametrize("case", FAMILIES)
@pytest.mark.parametrize("k", [4, 0])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_version_matches_the_pallas_kernel(case, k, dtype):
    _, _, _, j_run, t_run, R0, lam = _both(case, dtype, k)
    launches = mk.K2.launches
    # pure gradient steps (k = 0) on μ-conductance grow rounding ~4× per
    # step (its ddᵀ term makes the AL stiff, and G = 2·S(y)·R carries
    # σ·v·ddᵀR): two correct summation orders leave 1e-9 in G after ~9
    # steps in float64 and part after ~7 in float32
    long = 25 if k or case != "mucond" else (8 if dtype == "float64" else 5)
    for steps in (1, long):
        cj, vj = j_run(R0, lam, 1e-12, -np.inf, steps)
        ct, vt = t_run(R0, lam, 1e-12, -np.inf, steps)
        assert ct.steps == int(cj.steps) == steps
        assert ct.stagnated == bool(cj.stagnated)
        if dtype == "float64":
            tol = 1e-9
            for name in ("R", "G", "vio_raw", "y_full", "L_val",
                         "grad_norm"):
                np.testing.assert_allclose(
                    _np(getattr(ct, name)), _np(getattr(cj, name)),
                    rtol=tol, atol=tol, err_msg=f"{name} after {steps}")
            for name in ("s_hist", "y_hist", "rho"):
                np.testing.assert_allclose(
                    _np(getattr(ct.lbfgs, name)),
                    _np(getattr(cj.lbfgs, name)), rtol=tol, atol=tol,
                    err_msg=name)
            assert ct.lbfgs.head == int(cj.lbfgs.head)
            assert abs(float(vt) - float(vj)) < tol
        else:
            # the tolerances of tests/test_megakernel.py:81
            tol = 1e-4 if steps == 1 else 3e-3
            scale = abs(float(cj.L_val)) + 1.0
            assert abs(float(ct.L_val) - float(cj.L_val)) / scale < tol
            np.testing.assert_allclose(_np(ct.R), _np(cj.R), rtol=tol,
                                       atol=tol * 10)
            np.testing.assert_allclose(_np(ct.vio_raw), _np(cj.vio_raw),
                                       rtol=tol, atol=tol * 10)
            assert abs(float(vt) - float(vj)) < tol * 10
            assert abs(float(ct.grad_norm) - float(cj.grad_norm)) \
                / (float(cj.grad_norm) + 1e-9) < 0.05
    assert mk.K2.launches == launches   # CPU tensors never launch K2


@pytest.mark.parametrize("case", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_version_gtol_exit_and_ring_round_trip(case, dtype):
    """5 + 5 steps equal 10 (the ring round-trips through LBFGSState),
    and a loose gtol exits early — in both packages alike."""
    _, _, _, j_run, t_run, R0, lam = _both(case, dtype, 4)
    c1, _ = t_run(R0, lam, 1e-12, -np.inf, 5)
    c2, _ = t_run(c1.R, lam, 1e-12, -np.inf, 5, lbfgs=c1.lbfgs)
    c10, _ = t_run(R0, lam, 1e-12, -np.inf, 10)
    j10, _ = j_run(R0, lam, 1e-12, -np.inf, 10)
    assert c2.steps == 5 and c10.steps == 10
    atol = 2e-3 if dtype == "float32" else 1e-10
    for other in (c10, j10):
        np.testing.assert_allclose(_np(c2.R), _np(other.R), rtol=0,
                                   atol=atol)
    rel = abs(float(c2.L_val) - float(c10.L_val)) / (abs(float(c10.L_val))
                                                     + 1)
    assert rel < (1e-3 if dtype == "float32" else 1e-10)

    # gtol: half the gradient norm after one step (well below the start's)
    c_1, _ = t_run(R0, lam, 1e-12, -np.inf, 1)
    c_0, _ = t_run(R0, lam, 1e-12, -np.inf, 0)
    gtol = 0.5 * min(float(c_1.grad_norm), float(c_0.grad_norm))
    c_e, _ = t_run(R0, lam, gtol, -np.inf, 10000)
    j_e, _ = j_run(R0, lam, gtol, -np.inf, 10000)
    assert 0 < c_e.steps < 10000 and float(c_e.grad_norm) <= gtol
    assert c_e.steps == int(j_e.steps)
