"""A run with its timed path broken underneath comes out not correct, and
the TF32 control fails the check: the G1-shaped cell at its own size
(n = 800; on the CPU the port takes its dense torch loop where the card
runs K1), driven through the harness past its look for a card."""

import os
import time

import numpy as np

import pytest

from portbench import control, faults, harness

ROOT = os.path.dirname(harness.HERE)


@pytest.fixture(autouse=True)
def _few_threads():
    # the CPU solves are small; many intra-op threads in each of several
    # test workers only contend for the cores
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(seed: int, seconds: float = 1.0) -> dict:
    return harness.run_cell(ROOT, "maxcut-g1.gset", seed, seconds, False,
                            t0=time.time(), device="cpu")


def test_sound_run_is_correct():
    line = _run(2147483901, seconds=4.0)
    assert line["correct"], line["check"]
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["metrics"]) == {"solve_s", "solve_s_p90", "setup_s"}
    assert list(line)[-2:] == ["check", "_stderr"]


@pytest.mark.parametrize("fault", faults.NAMES)
def test_fault_is_caught(fault):
    with faults.planted(fault):
        line = _run(2147483902)
    assert not line["correct"], (fault, line["check"])


def test_tf32_fault_rounds_as_the_control_does():
    import torch

    from portbench.reference import tf32

    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    x[:4] = [0.0, -0.0, 1 + 2**-11, -(1 + 3 * 2**-11)]
    got = faults.round_tf32(torch.from_numpy(x)).numpy()
    assert got.tobytes() == tf32.tf32(x).tobytes()
    y = torch.from_numpy(x.astype(np.float64))
    assert faults.round_tf32(y).dtype == torch.float64


def test_tf32_fault_runs_under_the_harness():
    with faults.planted("tf32"):
        line = _run(2147483903)
    assert line["attempted"] >= 1
    assert set(line["check"]) == {"pinfeas", "gap", "obj_dev",
                                  "pinfeas_dev", "bound_over"}


def test_control_fails_and_program_passes():
    outs = list(control.readings(ROOT, "maxcut-g1.gset", [5, 6], 1.0,
                                 device="cpu"))
    for out in outs:
        assert out["correct"] and not out["control_correct"], out
