"""The device trace of a traced sub-window: ``torch.profiler`` over whole
solves, exported as a Chrome trace and reduced to what the per-layer
metrics and the result's ``breakdown`` read.

* ``kernels``: {name: [device seconds, launches]} of the device's own
  operations (kernels, copies, sets);
* ``busy_s``: the union of their intervals inside the sub-window;
* ``window_s``: the sub-window's length, from the harness's own span
  around it;
* ``idle``: {what the host was doing: idle seconds}, each gap in the
  union labelled with the innermost host event (an operator, a runtime
  call or a harness span) open on the main thread at its middle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile

WINDOW_SPAN = "portbench.traced_window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


@contextlib.contextmanager
def traced(out: dict):
    """Profile the body; on exit fill ``out`` with the reduced trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
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
    out.update(reduce_events(events))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events: list) -> dict:
    """Reduce a Chrome trace's events (µs) as the module says."""
    span = next((e for e in events if e.get("name") == WINDOW_SPAN
                 and e.get("ph") == "X"), None)
    if span is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    w0, w1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    kernels = collections.defaultdict(lambda: [0.0, 0])
    dev = []
    host = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            k = kernels[e["name"]]
            k[0] += d * 1e-6
            k[1] += 1
            lo, hi = max(s, w0), min(s + d, w1)
            if hi > lo:
                dev.append((lo, hi))
        elif cat in HOST_CATS and e.get("tid") == span.get("tid") \
                and e.get("name") != WINDOW_SPAN:
            host.append((s, s + d, e["name"]))
    busy = _union(dev)
    busy_us = sum(e - s for s, e in busy)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    host.sort()
    starts = [h[0] for h in host]
    # back[j]: the latest event before j that ends after it; the events
    # between them end no later than j, so a look-back may skip them
    back, stack = [], []
    for j, (_, end, _) in enumerate(host):
        while stack and host[stack[-1]][1] <= end:
            stack.pop()
        back.append(stack[-1] if stack else -1)
        stack.append(j)
    idle = collections.defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        # the latest-starting event still open at mid is the innermost,
        # however far back it opened
        j = bisect.bisect_right(starts, mid) - 1
        while j >= 0 and host[j][1] < mid:
            j = back[j]
        label = host[j][2] if j >= 0 else "host: no operator open"
        idle[label] += (e - s) * 1e-6
    return {"kernels": dict(kernels), "busy_s": busy_us * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "idle": dict(idle)}


def breakdown(tr: dict, top: int = 10) -> dict:
    ops = sorted(((k, v[0]) for k, v in tr["kernels"].items()),
                 key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
