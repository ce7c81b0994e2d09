"""One instance of a configuration's problem, in plain NumPy/SciPy: what
the solver under test and the float64 check both need, and nothing of
the solver itself.

    min ⟨C, X⟩  s.t.  ⟨Aᵢ, X⟩ = bᵢ, or ≤ bᵢ where ``types[i]``,  X ⪰ 0,
    Tr X ≤ ``trace_bound``

``constraints`` lists the Aᵢ, each an ``Entries`` or a ``LowRank``; None
means the unit diagonal constraints Xᵢᵢ = bᵢ (i = 1..n, MaxCut's), which
the harness builds once per side n and shares across the pool. ``types``
None means every constraint is an equality. ``params`` are the
configuration's problem parameters (its ``"params"``), kept for the
reference's certificate.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp


class Entries(NamedTuple):
    """A symmetric sparse Aᵢ by its stored entries, both triangles."""
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray


class LowRank(NamedTuple):
    """Aᵢ = B·Diag(d)·Bᵀ, B of shape (n, s) with small s."""
    B: np.ndarray
    d: np.ndarray


@dataclasses.dataclass(frozen=True)
class Instance:
    C: sp.csr_matrix
    b: np.ndarray
    trace_bound: float
    constraints: list | None = None
    types: np.ndarray | None = None
    params: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.C.shape[0]


def resolve_trace_bound(setting, inst: Instance) -> float:
    """The trace bound a configuration's ``solver.trace_bound`` states for
    ``inst``: ``"n"`` its side, a number that number, ``"instance"`` the
    bound the problem worked out for this instance."""
    if setting == "n":
        return float(inst.n)
    if setting == "instance":
        return float(inst.trace_bound)
    if isinstance(setting, (int, float)) and not isinstance(setting, bool):
        return float(setting)
    raise ValueError(f"trace_bound {setting!r}: the harness takes \"n\", "
                     "\"instance\" or a number")
