"""The reference's readings in TF32: the correctness check's control.

The configurations state float32 with TF32 off, so the nearest precision
below is TF32: operands rounded to 10 explicit mantissa bits, products
accumulated in float32, as the tensor cores do. Put in the solver's place
at the solver's own factor and multipliers, it gives what a solver that
certifies in TF32 would claim; the check has to find those claims wrong.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..instance import Instance
from . import maxcut


def tf32(x) -> np.ndarray:
    """Round to the nearest TF32 value (ties to even), kept as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    lsb = (u >> np.uint32(13)) & np.uint32(1)
    u = (u + np.uint32(0x0FFF) + lsb) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def certify(inst: Instance, R: np.ndarray, lam: np.ndarray) -> dict:
    """``maxcut.certify``'s readings, each computed from TF32 operands
    with float32 sums; λ_min of the TF32-rounded S in float64."""
    C, b, trace_bound = inst.C, inst.b, inst.trace_bound
    b32 = np.asarray(b, np.float32)
    Rt = tf32(R)
    rows = np.einsum("ij,ij->i", Rt, Rt, dtype=np.float32)
    pinfeas = float(np.linalg.norm(rows - b32) / np.linalg.norm(b32))
    Rh = tf32(Rt * (np.sqrt(b32) / np.sqrt(rows))[:, None])
    C32 = sp.csr_matrix((tf32(C.data), C.indices, C.indptr), shape=C.shape)
    upper = float(np.sum(Rh * (C32 @ Rh), dtype=np.float32))
    lam32 = tf32(lam)
    S = (C32 - sp.diags(lam32)).tocsr()
    S.data = tf32(S.data).astype(np.float64)
    lower = float(np.float32(lam32 @ b32)
                  + np.float32(trace_bound * min(0.0, maxcut.min_eig(S))))
    return {"pinfeas": pinfeas, "obj": upper, "bound": lower,
            "gap": maxcut.rel_gap(upper, lower)}
