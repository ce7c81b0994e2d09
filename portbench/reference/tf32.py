"""TF32 rounding, for the correctness check's control.

The configurations state float32 with TF32 off, so the nearest precision
below is TF32: operands rounded to 10 explicit mantissa bits, products
accumulated in float32, as the tensor cores do. Each problem's reference
brings its own control, ``certify_tf32(instance, R, λ)`` beside its
``certify`` (``maxcut.certify_tf32``), built on ``tf32`` here. Put in the
solver's place at the solver's own factor and multipliers, it gives what a
solver that certifies in TF32 would claim; the check has to find those
claims wrong.
"""

from __future__ import annotations

import numpy as np


def tf32(x) -> np.ndarray:
    """Round to the nearest TF32 value (ties to even), kept as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    lsb = (u >> np.uint32(13)) & np.uint32(1)
    u = (u + np.uint32(0x0FFF) + lsb) & np.uint32(0xFFFFE000)
    return u.view(np.float32)
