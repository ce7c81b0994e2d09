"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
its 700 W power limit): HBM3 at 3.35 TB/s, 67 TFLOP/s FP32 outside the
tensor cores, 34 TFLOP/s FP64."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def least_s(flops: float, nbytes: float, dtype: str = "float32"):
    """(least seconds for the work, "operations" or "bytes": which bounds
    it)."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
