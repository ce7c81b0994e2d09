"""Problem/solution exporters: SDPA and SDPLR-1.03 native formats.

A copy of the JAX package's ``utils/writers.py`` on the port's
``problem.py``: the files it writes are byte-identical to the JAX
package's. Equivalents of the
reference's writers (reference:
exps/data_utils.jl:16-152), used to cross-validate against the original
C SDPLR solver: SDPA sparse format, SDPLR format including low-rank
``l`` blocks, and SDPLR initial-solution (warm-start) files.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from ..problem import SDPProblem, SparseSym, SymLowRank, as_operand


def _triu_entries(A: SparseSym):
    keep = A.rows <= A.cols
    return A.rows[keep], A.cols[keep], A.vals[keep]


def write_problem_sdpa(path: str, C, As: Sequence, b) -> None:
    """SDPA sparse format (reference: exps/data_utils.jl:16-52).
    Indices are 1-based; C is written negated per the SDPA convention."""
    C = as_operand(C)
    As = [as_operand(A) for A in As]
    b = np.asarray(b, dtype=np.float64)
    if not isinstance(C, SparseSym) or any(not isinstance(A, SparseSym) for A in As):
        raise ValueError("SDPA export supports sparse operands only")
    n, m = C.n, len(As)
    with open(path, "w") as f:
        f.write(f"{m}\n1\n{n}\n")
        f.write(" ".join(repr(float(x)) for x in b) + " \n")
        ri, ci, vi = _triu_entries(C)
        for i, j, v in zip(ri, ci, vi):
            f.write(f"0 1 {i+1} {j+1} {float(-v)!r}\n")
        for k, A in enumerate(As):
            ri, ci, vi = _triu_entries(A)
            for i, j, v in zip(ri, ci, vi):
                f.write(f"{k+1} 1 {i+1} {j+1} {float(v)!r}\n")


def _write_matrix_sdplr(A: Union[SparseSym, SymLowRank], mat_id: int, f) -> None:
    if isinstance(A, SparseSym):
        ri, ci, vi = _triu_entries(A)
        f.write(f"{mat_id} 1 s {len(vi)}\n")
        for i, j, v in zip(ri, ci, vi):
            f.write(f"{i+1} {j+1} {float(v)!r}\n")
    elif isinstance(A, SymLowRank):
        s = A.B.shape[1]
        f.write(f"{mat_id} 1 l {s}\n")
        for dv in A.d:
            f.write(f"{float(dv)!r}\n")
        for j in range(s):
            for i in range(A.B.shape[0]):
                f.write(f"{float(A.B[i, j])!r}\n")
    else:
        raise ValueError("Only sparse and low-rank matrices are supported in SDPLR.")


def write_problem_sdplr(path: str, C, As: Sequence, b) -> None:
    """SDPLR-1.03 native format incl. low-rank ``l`` blocks
    (reference: exps/data_utils.jl:54-119)."""
    C = as_operand(C)
    As = [as_operand(A) for A in As]
    b = np.asarray(b, dtype=np.float64)
    n, m = C.n, len(As)
    with open(path, "w") as f:
        f.write(f"{m}\n1\n{n}\n")
        f.write(" ".join(repr(float(x)) for x in b) + " \n")
        f.write("1\n")  # ignored by SDPLR
        _write_matrix_sdplr(C, 0, f)
        for k, A in enumerate(As):
            _write_matrix_sdplr(A, k + 1, f)


def write_initial_solution(path: str, R: np.ndarray, lam: np.ndarray) -> None:
    """SDPLR-1.03 warm-start file (reference: exps/data_utils.jl:122-152).
    R is the n×r factor; lam the m duals."""
    R = np.asarray(R, dtype=np.float64)
    lam = np.asarray(lam, dtype=np.float64).reshape(-1)
    n, r = R.shape
    with open(path, "w") as f:
        f.write(f"dual variable {len(lam)}\n")
        for v in lam:
            f.write(f"{float(v)!r}\n")
        f.write(f"primal variable 1 s {n} {r} {r}\n")
        for j in range(r):
            for i in range(n):
                f.write(f"{float(R[i, j])!r}\n")
        f.write("special majiter 0\n")
        f.write("special iter 0\n")
        f.write("special lambdaupdate 0")
        f.write("special CG 0\n")
        f.write("special curr_CG 0\n")
        f.write("special totaltime 0\n")
        f.write(f"special sigma {float(1.0 / n)!r}\n")
        f.write("special scale 1.0\n")


def read_problem_sdplr(path: str):
    """Reader for the SDPLR format written above (round-trip support;
    the reference only writes this format). Returns (C, As, b)."""
    with open(path) as f:
        tokens = f.read().split("\n")
    it = iter(tokens)
    m = int(next(it))
    nblocks = int(next(it))
    if nblocks != 1:
        raise ValueError("only single-block SDPLR files supported")
    n = int(next(it))
    b = np.array([float(x) for x in next(it).split()])
    next(it)  # ignored line
    mats = {}
    line = None
    remaining = []
    for t in it:
        remaining.append(t)
    pos = 0

    def next_line():
        nonlocal pos
        while pos < len(remaining) and remaining[pos].strip() == "":
            pos += 1
        if pos >= len(remaining):
            return None
        out = remaining[pos]
        pos += 1
        return out

    while True:
        header = next_line()
        if header is None:
            break
        parts = header.split()
        mat_id, _, kind = int(parts[0]), parts[1], parts[2]
        if kind == "s":
            nnz = int(parts[3])
            ri, ci, vi = [], [], []
            for _ in range(nnz):
                i, j, v = next_line().split()
                i, j, v = int(i) - 1, int(j) - 1, float(v)
                ri.append(i)
                ci.append(j)
                vi.append(v)
                if i != j:
                    ri.append(j)
                    ci.append(i)
                    vi.append(v)
            mats[mat_id] = SparseSym(np.array(ri), np.array(ci), np.array(vi), n)
        elif kind == "l":
            s = int(parts[3])
            d = np.array([float(next_line()) for _ in range(s)])
            B = np.empty((n, s))
            for j in range(s):
                for i in range(n):
                    B[i, j] = float(next_line())
            mats[mat_id] = SymLowRank(B, d)
        else:
            raise ValueError(f"unknown SDPLR block kind {kind!r}")
    C = mats.pop(0)
    As = [mats[k] for k in sorted(mats)]
    if len(As) != m:
        raise ValueError("SDPLR file: constraint count mismatch")
    return C, As, b
