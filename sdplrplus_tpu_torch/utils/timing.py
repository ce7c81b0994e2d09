"""Timing on the card and its peak rates, for the port's measuring
scripts (``bench.py``, ``exps/bench_micro.py``, ``probes.py`` and the
repository's ``chip_smoke.py``).

A bound is the least time the card could take for some work: the larger
of the bytes it must move (every input read once, every output written
once) over the memory rate and its operations over the peak rate of their
type (non-tensor FP32 or FP64, the rates of an H100 SXM).
"""

from __future__ import annotations

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
