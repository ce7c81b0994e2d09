"""The reader of ``capture_frees_per_solve`` on hand-made counter deltas:
the port's ``inner.capture_frees`` over the traced solves, and nothing
where the traced solves made no capture into a kept pool (a port without
the pool counts no ``inner.pooled_captures``) or the run was not
traced."""

import collections
import types

from portbench import harness


def _ctx(counts, traced=4):
    return types.SimpleNamespace(
        counts=None if counts is None else collections.Counter(counts),
        traced=[{}] * traced)


def test_capture_frees_per_solve():
    read = harness.load_module("metrics", "capture_frees_per_solve").read
    # a window's deltas drop the counters that stayed at 0
    assert read(_ctx({"inner.captures": 4, "inner.pooled_captures": 4})) \
        == 0.0
    assert read(_ctx({"inner.pooled_captures": 4,
                      "inner.capture_frees": 10})) == 2.5
    assert read(_ctx({"inner.captures": 4, "inner.steps": 900})) is None
    assert read(_ctx(None)) is None
    assert read(_ctx({"inner.pooled_captures": 1}, traced=0)) is None
