"""The port's ``sdplr.*`` host spans (``sdplrplus_tpu_torch/utils/timing.py``,
its ``SPANS``) in a traced run: from the profiler's Chrome trace, and from
the port's own totals of the spans a profiler saw.

* ``reduce(events, window)``: for each span name on the window's thread,
  ``count``, ``wall_s``, ``self_s`` (wall less the union of its direct
  children) and ``device_s`` (the device time of the kernels, copies and
  sets whose launching runtime call lies inside that span and no deeper
  one, matched by Kineto's ``correlation`` id, so a graph replay's kernels
  go to its ``cudaGraphLaunch``); the number of ``sdplr.solve`` spans; and
  ``idle_by_span``, each idle gap of the window put down to the innermost
  span open at its middle, or to ``outside the solver``.
* ``program_totals()``: the port's ``TOTALS`` (count, wall and self
  seconds by name, of the spans closed while a profiler ran; in a run,
  the traced solves), which the per-layer metrics ``dual_bound_ms``,
  ``boundary_ms``, ``driver_self_ms`` and ``capture_ms`` read. None
  where the port keeps no such totals.
* ``traced(out)``: the traced sub-window as ``trace.traced`` profiles it,
  keeping ``trace.reduce_events``' reduction under ``out["trace"]`` and
  this module's under ``out["spans"]`` (``spantable.py`` uses it).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile

from . import trace

PREFIX = "sdplr."
SOLVE = "sdplr.solve"
OUTSIDE = "outside the solver"
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


def _clipped_union(intervals, lo, hi) -> list:
    return trace._union([(max(s, lo), min(e, hi)) for s, e in intervals
                         if min(e, hi) > max(s, lo)])


def reduce(events: list, window: dict) -> dict:
    """Reduce a Chrome trace's events (µs) to the spans' table, as the
    module says; ``window`` is the traced window's own event."""
    w0 = float(window["ts"])
    w1 = w0 + float(window["dur"])
    tid = window.get("tid")
    spans, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e.get("tid") == tid \
                and str(e.get("name", "")).startswith(PREFIX) \
                and s >= w0 and s + d <= w1:
            spans.append([s, s + d, e["name"]])
        elif cat in LAUNCH_CATS and e.get("tid") == tid and corr is not None:
            launches[corr] = s
        elif cat in trace.DEVICE_CATS:
            device.append((s, s + d, corr))
    # nesting: by start, the longer first; a span's parent is the nearest
    # open span that holds it
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    parent, stack = [], []
    for i, (s, e, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] < e:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    starts = [sp[0] for sp in spans]

    def innermost(t: float):
        i = bisect.bisect_right(starts, t) - 1
        while i is not None and i >= 0 and spans[i][1] < t:
            i = parent[i]
        return None if i is None or i < 0 else i

    children = collections.defaultdict(list)
    for i, p in enumerate(parent):
        if p is not None:
            children[p].append((spans[i][0], spans[i][1]))
    dev_of = collections.defaultdict(float)
    for s, e, corr in device:
        t = launches.get(corr)
        if t is not None:
            i = innermost(t)
            if i is not None:
                dev_of[i] += e - s
    by_name = {}
    for i, (s, e, name) in enumerate(spans):
        row = by_name.setdefault(name, {"count": 0, "wall_s": 0.0,
                                        "self_s": 0.0, "device_s": 0.0})
        kids = sum(b - a for a, b in _clipped_union(children[i], s, e))
        row["count"] += 1
        row["wall_s"] += (e - s) * 1e-6
        row["self_s"] += (e - s - kids) * 1e-6
        row["device_s"] += dev_of[i] * 1e-6

    busy = _clipped_union([(s, e) for s, e, _ in device], w0, w1)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    idle = collections.defaultdict(float)
    for s, e in gaps:
        i = innermost(0.5 * (s + e))
        idle[OUTSIDE if i is None else spans[i][2]] += (e - s) * 1e-6
    return {"solves": sum(1 for sp in spans if sp[2] == SOLVE),
            "by_name": by_name, "idle_by_span": dict(idle)}


def program_totals() -> dict | None:
    """{(name, "count" | "wall_s" | "self_s"): total} of the port's spans
    closed under a profiler in this process, or None where the port keeps
    no totals."""
    try:
        from sdplrplus_tpu_torch.utils import timing
    except ImportError:
        return None
    totals = getattr(timing, "TOTALS", None)
    return None if totals is None else dict(totals)


def per_solve_ms(name: str, field: str) -> float | None:
    """The port's total ``field`` ("wall_s" or "self_s") of span ``name``
    over its ``sdplr.solve`` spans, in ms: 0 where such solves ran none;
    None where no solve ran under a profiler or the port keeps no
    totals."""
    totals = program_totals()
    if not totals:
        return None
    solves = totals.get((SOLVE, "count"), 0)
    if not solves:
        return None
    return 1e3 * totals.get((name, field), 0.0) / solves


@contextlib.contextmanager
def traced(out: dict):
    """Profile the body as ``trace.traced`` does; on exit fill ``out`` with
    ``trace``: its reduction, and ``spans``: this module's."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW_SPAN):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    window = next(e for e in events if e.get("name") == trace.WINDOW_SPAN
                  and e.get("ph") == "X")
    out["trace"] = trace.reduce_events(events)
    out["spans"] = reduce(events, window)
