"""Timing on the card and its peak rates, for the port's measuring
scripts (``bench.py``, ``exps/bench_micro.py``, ``probes.py`` and the
repository's ``chip_smoke.py``), and the solver's named host spans.

A bound is the least time the card could take for some work: the larger
of the bytes it must move (every input read once, every output written
once) over the memory rate and its operations over the peak rate of their
type (non-tensor FP32 or FP64, the rates of an H100 SXM).
"""

from __future__ import annotations

import collections
import time

import torch

PEAK_BYTES_PER_S = 3.35e12                        # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # non-tensor


def bound_s(nbytes: float, flops: float, dtype: str = "float32"):
    """(least seconds for the work, "bytes" or "operations": which of the
    two bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class Timer:
    """Seconds of the work between ``start`` and ``stop``: CUDA events on
    the card (the device's time, the host's enqueue excluded), the host
    clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"

    def start(self):
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.e1.record()
            torch.cuda.synchronize()
            return self.e0.elapsed_time(self.e1) / 1e3
        return time.perf_counter() - self.t0


def kernel_us(prof) -> dict:
    """{kernel name: (device µs, launches)} of a finished
    ``torch.profiler.profile``: only the kernels' own events (device type
    CUDA) count, since an operator's event carries the time of the kernels
    it launched too."""
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] = (us, ev.count)
    return out


# ---- named host spans -------------------------------------------------------

# every span the solver opens (solver/outer.py, solver/major.py,
# solver/inner.py, solver/inner_entry.py), nested as the calls are
SPANS = (
    ("sdplr.problem", "sdplr(): SDPProblem's normalisation of C and the Aᵢ"),
    ("sdplr.solve", "one whole solve, the parent of every span below"),
    ("sdplr.preprocess", "compile_problem and the upload; preprocess_time"),
    ("sdplr.preprocess.compile", "compile_problem on the host"),
    ("sdplr.preprocess.upload", "the compiled problem to the device"),
    ("sdplr.setup", "a driver's start: R and λ, the megakernel's data, fg!"),
    ("sdplr.state_read", "the state machine's one host read before a body"),
    ("sdplr.inner", "one inner activation: replays and reads, a K1/K2 "
     "launch, or an entry chunk"),
    ("sdplr.inner.capture", "warm-up steps and the capture of a CUDA graph"),
    ("sdplr.boundary", "one major boundary"),
    ("sdplr.dual_bound", "one Lanczos dual bound, scalar or block, to its "
     "read"),
    ("sdplr.rank_double", "the new carry after rank doubling"),
    ("sdplr.finish", "after the loop: the fallback bound, DIMACS errors, R "
     "to the host, the feasible objective"),
    ("sdplr.polish", "the host float64 dual polish, when it runs"),
)

# (name, "count" | "wall_s" | "self_s") → total over the spans closed
# while a profiler ran; self time is wall time less the direct children's
TOTALS = collections.Counter()

_profiling = torch._C._autograd._profiler_enabled
_open: list = []   # the spans open under the profiler, innermost last


class span:
    """``with span(name) as s:`` times the body on the host's clock into
    ``s.seconds``. While a profiler runs (the flag is read on entry) the
    body is also a ``record_function`` range, a ``user_annotation`` in
    the profiler's trace on the kernels' clock, and the span adds to
    ``TOTALS``; otherwise it costs the flag's read and two clock reads.
    A span reads no device value and waits for nothing on the device."""

    __slots__ = ("name", "seconds", "_t0", "_rf", "_children")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._rf = None

    def __enter__(self):
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            self._children = 0.0
            _open.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
            if _open and _open[-1] is self:
                _open.pop()
                if _open:
                    _open[-1]._children += self.seconds
            TOTALS[self.name, "count"] += 1
            TOTALS[self.name, "wall_s"] += self.seconds
            TOTALS[self.name, "self_s"] += self.seconds - self._children
        return False
