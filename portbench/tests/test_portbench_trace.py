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


def test_idle_gap_label_looks_back_past_512_events():
    """A gap is put down to the innermost host event open at its middle,
    however many events closed inside that one before the gap."""
    events = [_x(trace.WINDOW_SPAN, "user_annotation", 0.0, 10000.0),
              _x("sdplr.dual_bound", "user_annotation", 10.0, 9000.0)]
    events += [_x("aten::mul", "cpu_op", 20.0 + 10 * i, 4.0)
               for i in range(600)]
    events += [_x("k", "kernel", 6050.0, 10.0, tid=7),
               _x("k", "kernel", 9500.0, 500.0, tid=7)]
    got = trace.reduce_events(events)
    # gaps [0, 6050] (mid 3025) and [6060, 9500] (mid 7780, 600 events
    # after the bound opened): both the bound's
    assert got["idle"] == {"sdplr.dual_bound": pytest.approx(9490e-6)}
    assert got["busy_s"] == pytest.approx(510e-6)


@pytest.mark.parametrize("seed", range(5))
def test_idle_gap_label_is_the_latest_event_open(seed):
    """Against a scan of every host event: the latest-starting one still
    open at the gap's middle, on random, partly overlapping events."""
    import numpy as np

    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0, 1000, 300))
    host = [(float(s), float(s + d), f"op{i}") for i, (s, d) in enumerate(
        zip(starts, rng.exponential(40, 300)))]
    kern = [(float(s), float(s + d)) for s, d in zip(
        np.sort(rng.uniform(0, 1000, 60)), rng.uniform(0, 3, 60))]
    events = [_x(trace.WINDOW_SPAN, "user_annotation", 0.0, 1000.0)]
    events += [_x(n, "cpu_op", s, e - s) for s, e, n in host]
    events += [_x("k", "kernel", s, e - s, tid=7) for s, e in kern]
    busy = trace._union(kern)
    gaps, t = [], 0.0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < 1000.0:
        gaps.append((t, 1000.0))
    want = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        open_ = [h for h in host if h[0] <= mid <= h[1]]
        label = max(open_)[2] if open_ else "host: no operator open"
        want[label] = want.get(label, 0.0) + (e - s) * 1e-6
    got = trace.reduce_events(events)["idle"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k])
