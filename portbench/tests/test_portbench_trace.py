"""The reduction of a Chrome trace to busy time, kernel times and idle
gaps, on a hand-made trace."""

import pytest

from portbench import trace


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_reduce_events():
    events = [
        _x(trace.WINDOW_SPAN, "user_annotation", 0.0, 100.0),
        _x("aten::mm", "cpu_op", 5.0, 10.0),
        _x("cudaGraphLaunch", "cuda_runtime", 40.0, 20.0),
        _x("other_thread_op", "cpu_op", 30.0, 60.0, tid=2),
        _x("k_a", "kernel", 10.0, 20.0, tid=7),
        _x("k_a", "kernel", 25.0, 10.0, tid=7),     # overlaps the first
        _x("copy", "gpu_memcpy", 70.0, 10.0, tid=7),
        _x("k_late", "kernel", 95.0, 20.0, tid=7),  # past the window
    ]
    got = trace.reduce_events(events)
    assert got["window_s"] == pytest.approx(100e-6)
    # union inside the window: [10, 35] + [70, 80] + [95, 100]
    assert got["busy_s"] == pytest.approx(40e-6)
    assert got["kernels"]["k_a"] == [pytest.approx(30e-6), 2]
    assert got["kernels"]["k_late"][1] == 1
    # gaps [0, 10] (mid 5: aten::mm), [35, 70] (mid 52.5: the graph
    # launch; the other thread's op does not count), [80, 95] (none)
    assert got["idle"] == {"aten::mm": pytest.approx(10e-6),
                           "cudaGraphLaunch": pytest.approx(35e-6),
                           "host: no operator open": pytest.approx(15e-6)}
    b = trace.breakdown(got)
    assert b["device_ops"][0][0] == "k_a"
    assert b["idle_gaps"][0] == ["cudaGraphLaunch", pytest.approx(35e-6)]


def test_reduce_events_needs_the_window_span():
    with pytest.raises(RuntimeError):
        trace.reduce_events([_x("k", "kernel", 0.0, 1.0)])
