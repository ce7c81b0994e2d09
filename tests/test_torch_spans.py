"""The solver's named host spans (``utils/timing.span``, ``SPANS``).

A small MaxCut solve on the CPU runs under ``torch.profiler`` through
both drivers, and its exported Chrome trace is read back: one
``sdplr.solve`` holding ``sdplr.preprocess``, one ``sdplr.boundary`` per
major iteration, one ``sdplr.dual_bound`` per bound the solve computed,
no ``sdplr.polish`` at ``maxtime`` ≤ 30 s, and only names that ``SPANS``
lists. ``TOTALS`` holds the same counts. With no profiler running a span
enters no ``record_function`` and still times, and the spans change no
host read of the inner loop and no result.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdplrplus_tpu_torch import sdplr
from sdplrplus_tpu_torch.models import problems as t_models
from sdplrplus_tpu_torch.solver import inner as t_inner
from sdplrplus_tpu_torch.utils import timing
from sdplrplus_tpu_torch.utils.timing import SPANS, TOTALS, span

NAMES = {name for name, _ in SPANS}
KW = dict(ptol=1e-3, objtol=1e-3, prior_trace_bound=30.0, maxtime=30.0,
          dtype="float64", device="cpu", printlevel=0, seed=3)


def _maxcut(n=30):
    return t_models.maxcut(t_models.make_random_graph(n, 0.3, seed=5))


def _spans(path) -> list:
    """(name, start µs, end µs) of the trace's ``sdplr.*`` annotations,
    by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and str(e.get("name", "")).startswith("sdplr.")]
    return sorted(out, key=lambda s: s[1])


def _count(spans, name) -> int:
    return sum(1 for s in spans if s[0] == name)


def _inside(outer, inner) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("fused", [True, False])
def test_spans_of_a_profiled_solve(tmp_path, fused):
    """The trace of one solve under the profiler, through either driver:
    the spans' counts against the result's, their nesting, and TOTALS."""
    C, As, b = _maxcut()
    before = TOTALS.copy()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = sdplr(C, As, b, 3, fused_outer=fused, **KW)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = _spans(path)

    assert {s[0] for s in spans} <= NAMES
    solves = [s for s in spans if s[0] == "sdplr.solve"]
    assert len(solves) == 1
    pre = [s for s in spans if s[0] == "sdplr.preprocess"]
    assert len(pre) == 1 and _inside(solves[0], pre[0])
    for name in ("sdplr.preprocess.compile", "sdplr.preprocess.upload"):
        (part,) = [s for s in spans if s[0] == name]
        assert _inside(pre[0], part)
    assert _count(spans, "sdplr.problem") == 1
    assert _count(spans, "sdplr.setup") == 1
    assert _count(spans, "sdplr.finish") == 1
    assert res["majoriter"] > 0
    assert _count(spans, "sdplr.boundary") == res["majoriter"]
    assert res["dual_bounds_computed"] > 0
    assert _count(spans, "sdplr.dual_bound") == res["dual_bounds_computed"]
    assert _count(spans, "sdplr.polish") == 0
    assert _count(spans, "sdplr.inner") > 0
    # every span but the problem's lies inside the solve, and every bound
    # inside a boundary or the finish
    for s in spans:
        if s[0] != "sdplr.problem":
            assert _inside(solves[0], s), s
    outer = [s for s in spans if s[0] in ("sdplr.boundary", "sdplr.finish")]
    for s in spans:
        if s[0] == "sdplr.dual_bound":
            assert any(_inside(o, s) for o in outer), s
    if fused:
        assert _count(spans, "sdplr.state_read") == (
            _count(spans, "sdplr.inner") + res["majoriter"])

    delta = TOTALS.copy()
    delta.subtract(before)
    for name in NAMES:
        assert delta[name, "count"] == _count(spans, name), name
        assert 0.0 <= delta[name, "self_s"] <= delta[name, "wall_s"] + 1e-9
    assert abs(res["preprocess_time"] - 1e-6 * (pre[0][2] - pre[0][1])) \
        < 0.05 + 0.5 * res["preprocess_time"]


def test_spans_change_no_read_and_no_result():
    """The same seeded solve with the profiler off and on: the inner
    loop's counters (steps, chunks, reads, the state machine's branch
    reads) and the result are the same."""
    C, As, b = _maxcut()
    runs = []
    for on in (False, True):
        t_inner.STATS.clear()
        if on:
            with profile(activities=[ProfilerActivity.CPU]):
                res = sdplr(C, As, b, 3, **KW)
        else:
            res = sdplr(C, As, b, 3, **KW)
        runs.append((dict(t_inner.STATS), res))
    (st_off, r_off), (st_on, r_on) = runs
    assert st_off == st_on
    assert st_off["reads"] > 0 and st_off["branch_reads"] > 0
    assert "boundaries" not in st_off
    assert r_off["iter"] == r_on["iter"]
    assert r_off["majoriter"] == r_on["majoriter"]
    assert r_off["obj"] == r_on["obj"]
    np.testing.assert_array_equal(r_off["R"], r_on["R"])


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    """With no profiler running a span never builds a record_function,
    still times its body, and adds nothing to TOTALS; a whole solve runs
    so and reports its preprocessing time from its span."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = TOTALS.copy()
    with span("sdplr.solve") as s:
        time.sleep(0.01)
    assert 0.009 <= s.seconds < 1.0
    res = sdplr(*_maxcut(), 3, **KW)
    assert res["preprocess_time"] > 0.0
    assert TOTALS == before


def test_span_names_are_listed_once():
    """SPANS names each span once, with a one-line meaning, and the
    solver's sources open no span it does not list."""
    import pathlib
    import re

    names = [name for name, _ in SPANS]
    assert len(names) == len(set(names))
    assert all(name.startswith("sdplr.") for name in names)
    assert all(meaning and "\n" not in meaning for _, meaning in SPANS)
    root = pathlib.Path(timing.__file__).resolve().parents[1]
    opened = set()
    for src in root.rglob("*.py"):
        opened |= set(re.findall(r'span\("([^"]+)"\)', src.read_text()))
    assert opened == set(names)
