"""The roofline counts against hand-computed values at a small shape."""

import pytest

from portbench.counts import lbfgs_step, peaks


def test_fastdiag_step_small():
    # n = 4 rows, 6 stored entries, r = 2, k = 1, float32
    flops, nbytes = lbfgs_step.fastdiag_step(4, 6, 2, 1)
    assert flops == 2 * 6 * 2 + (8 + 29) * 4 * 2 + 18 * 4 == 392
    assert nbytes == 6 * 8 + 4 * 4 * 2 * (3 + 2 + 3 + 2) + 4 * 4 == 384


def test_k1_small():
    assert lbfgs_step.k1_iteration_flops(4, 2, 1) == 2 * 16 * 2 + 296 + 72
    # C, R in and out, the ring of 2k vectors in and out, four n-vectors
    assert lbfgs_step.k1_launch_bytes(4, 2, 1) == 4 * (16 + 16 + 32 + 16)


def test_k1_at_g1_size():
    # n_pad 896, r = 10, k = 4: 16.62 Mflop, 0.248 us at 67 TFLOP/s
    f = lbfgs_step.k1_iteration_flops(896, 10, 4)
    assert f == 2 * 896 ** 2 * 10 + 61 * 8960 + 18 * 896
    t, by = peaks.least_s(f, 0.0)
    assert by == "operations" and t == pytest.approx(0.248e-6, rel=1e-2)


def test_least_s_picks_the_larger():
    t, by = peaks.least_s(67e12, 2 * 3.35e12)
    assert (t, by) == (2.0, "bytes")
    t, by = peaks.least_s(2 * 34e12, 0.0, "float64")
    assert (t, by) == (2.0, "operations")
