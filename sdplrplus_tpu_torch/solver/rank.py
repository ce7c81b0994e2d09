"""Rank schedule: Barvinok–Pataki bound and rank doubling.

(reference: src/utils.jl:1-11, src/coreop.jl:516-526)
"""

from __future__ import annotations

import math


def barvinok_pataki(n: int, m: int) -> int:
    """min{n, ⌊√(2m) + 1⌋} (reference: src/utils.jl:7-9)."""
    return min(n, int(math.floor(math.sqrt(2.0 * m) + 1.0)))


def next_rank(r: int, n: int, m: int) -> int:
    """Doubling capped at the Barvinok–Pataki bound
    (reference: src/coreop.jl:518-525)."""
    return min(barvinok_pataki(n, m), 2 * r)
