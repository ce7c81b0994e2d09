"""The reduction of the port's ``sdplr.*`` spans in a Chrome trace, on a
hand-made trace: nesting, self time, device time by correlation id, idle
time by innermost span; ``trace.reduce_events`` unchanged by the spans;
and the span metrics' readers on the port's totals."""

import types

import pytest

from portbench import harness, spans, trace


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    ua, rt, k = "user_annotation", "cuda_runtime", "kernel"
    return [
        _x(trace.WINDOW_SPAN, ua, 0.0, 1000.0),
        _x("sdplr.solve", ua, 10.0, 890.0),
        _x("sdplr.preprocess", ua, 20.0, 80.0),
        _x("sdplr.preprocess.compile", ua, 20.0, 40.0),
        _x("sdplr.inner", ua, 200.0, 200.0),
        _x("sdplr.boundary", ua, 500.0, 200.0),
        _x("sdplr.dual_bound", ua, 550.0, 100.0),
        _x("sdplr.inner", ua, 0.0, 900.0, tid=2),      # another thread
        _x("aten::mm", "cpu_op", 150.0, 20.0),
        _x("cudaLaunchKernel", rt, 250.0, 5.0, corr=1),
        _x("cudaGraphLaunch", rt, 300.0, 5.0, corr=2),
        _x("cudaLaunchKernel", rt, 520.0, 3.0, corr=4),
        _x("cudaLaunchKernel", rt, 600.0, 3.0, corr=3),
        _x("cudaLaunchKernel", rt, 950.0, 3.0, corr=5),
        _x("k1", k, 260.0, 20.0, tid=7, corr=1),
        _x("g1", k, 310.0, 40.0, tid=7, corr=2),      # a replay's two
        _x("g2", k, 350.0, 40.0, tid=7, corr=2),      # kernels
        _x("k4", k, 525.0, 10.0, tid=7, corr=4),
        _x("k3", "gpu_memcpy", 610.0, 30.0, tid=7, corr=3),
        _x("k5", k, 960.0, 10.0, tid=7, corr=5),
        _x("k6", k, 980.0, 10.0, tid=7, corr=99),     # no launch seen
        _x("sdplr.inner", "gpu_user_annotation", 200.0, 200.0, tid=7),
    ]


def test_reduce_spans():
    events = _events()
    window = events[0]
    got = spans.reduce(events, window)
    assert got["solves"] == 1
    t = got["by_name"]
    us = lambda v: pytest.approx(v * 1e-6)
    assert t["sdplr.solve"] == {"count": 1, "wall_s": us(890),
                                "self_s": us(890 - 80 - 200 - 200),
                                "device_s": 0.0}
    assert t["sdplr.preprocess"]["self_s"] == us(40)
    assert t["sdplr.preprocess.compile"]["wall_s"] == us(40)
    assert t["sdplr.inner"]["count"] == 1          # not the other thread's
    assert t["sdplr.inner"]["device_s"] == us(20 + 80)
    assert t["sdplr.boundary"]["self_s"] == us(100)
    assert t["sdplr.boundary"]["device_s"] == us(10)
    assert t["sdplr.dual_bound"]["device_s"] == us(30)
    # busy [260, 280], [310, 390], [525, 535], [610, 640], [960, 970],
    # [980, 990]; each gap goes to the innermost span open at its middle
    idle = got["idle_by_span"]
    assert idle == {"sdplr.solve": us(260 + 135 + 320),
                    "sdplr.inner": us(30), "sdplr.dual_bound": us(75),
                    spans.OUTSIDE: us(20)}
    assert sum(idle.values()) == us(1000 - 160)


def test_reduce_events_keeps_its_keys_with_spans():
    """The spans and the device-side annotation add no busy time, and
    ``reduce_events`` returns what it always did."""
    got = trace.reduce_events(_events())
    assert set(got) == {"kernels", "busy_s", "window_s", "idle"}
    assert got["busy_s"] == pytest.approx(160e-6)
    assert "sdplr.inner" not in got["kernels"]


def test_span_metrics_read_the_ports_totals(monkeypatch):
    from sdplrplus_tpu_torch.utils import timing

    ctx = types.SimpleNamespace(trace={"kernels": {}})
    reader = lambda m: harness.load_module("metrics", m).read(ctx)
    totals = {("sdplr.solve", "count"): 4, ("sdplr.solve", "self_s"): 0.4,
              ("sdplr.dual_bound", "wall_s"): 0.2,
              ("sdplr.boundary", "self_s"): 0.1}
    monkeypatch.setattr(timing, "TOTALS", totals)
    assert reader("dual_bound_ms") == pytest.approx(50.0)
    assert reader("boundary_ms") == pytest.approx(25.0)
    assert reader("driver_self_ms") == pytest.approx(100.0)
    assert reader("capture_ms") == 0.0
    # no traced sub-window, no traced solve, or a port without totals
    assert harness.load_module("metrics", "dual_bound_ms").read(
        types.SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(timing, "TOTALS", {})
    assert reader("dual_bound_ms") is None
    monkeypatch.delattr(timing, "TOTALS")
    assert reader("boundary_ms") is None
