"""Problem containers: the user-facing SDP description.

TPU-native re-design of the reference's problem layer
(reference: src/structs.jl:11-183). The reference supports four operand
types — SparseMatrixCSC, SparseMatrixCOO, Diagonal, SymLowRankMatrix
(reference: src/sdplr.jl:29-34). Here every sparse/diagonal operand is
normalized to COO triplets on the host; the low-rank operand keeps its
(B, d) factors, which map straight onto MXU matmuls on device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

try:  # scipy is host-side-only convenience; core never requires it on device
    import scipy.sparse as _sp
except ImportError:  # pragma: no cover
    _sp = None


@dataclasses.dataclass(frozen=True)
class SymLowRank:
    """Symmetric low-rank matrix B @ diag(d) @ B.T.

    Equivalent of the reference's exported ``SymLowRankMatrix``
    (reference: src/structs.jl:11-24). ``B`` is (n, s) with tiny s;
    on TPU both the constraint evaluation (UᵀB contractions) and the
    adjoint rank-s update are dense tall-skinny matmuls on the MXU.
    """

    B: np.ndarray  # (n, s)
    d: np.ndarray  # (s,)

    def __post_init__(self):
        B = np.asarray(self.B, dtype=np.float64)
        d = np.asarray(self.d, dtype=np.float64).reshape(-1)
        if B.ndim != 2 or d.shape[0] != B.shape[1]:
            raise ValueError(f"SymLowRank: B {B.shape} incompatible with d {d.shape}")
        object.__setattr__(self, "B", B)
        object.__setattr__(self, "d", d)

    @property
    def n(self) -> int:
        return self.B.shape[0]

    def todense(self) -> np.ndarray:
        return (self.B * self.d[None, :]) @ self.B.T

    def norm_fro(self) -> float:
        # ||B D Bᵀ||_F via the s×s Gram trick: ||BDBᵀ||_F² = tr(DGDG), G = BᵀB.
        G = self.B.T @ self.B
        M = (self.d[:, None] * G) @ (self.d[:, None] * G)
        return float(np.sqrt(max(np.trace(M), 0.0)))

    def norm(self, p=2) -> float:
        """Matrix norm like the reference's ``norm(A, 2/Inf)`` overloads
        (reference: src/structs.jl:60-76): p=2 → Frobenius (the reference's
        norm(A, 2) is the entrywise 2-norm), p=inf → max |entry|."""
        if p == 2:
            return self.norm_fro()
        if p in (np.inf, float("inf"), "inf"):
            # max |(BDBᵀ)_ij|, row-chunked to keep memory O(chunk·n)
            BD = self.B * self.d[None, :]
            best = 0.0
            for lo in range(0, self.n, 4096):
                best = max(best, float(np.abs(
                    BD[lo:lo + 4096] @ self.B.T).max()))
            return best
        raise ValueError(f"SymLowRank.norm: unsupported p={p!r} (2 or inf)")

    def __getitem__(self, ij):
        """Entrywise access (BDBᵀ)_ij (reference getindex, src/structs.jl:44)."""
        i, j = ij
        return float((self.B[i] * self.d) @ self.B[j])

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """B (d ⊙ (Bᵀ x)) — the mul! analog (reference: src/structs.jl:78-145)."""
        return self.B @ (self.d * (self.B.T @ x))


@dataclasses.dataclass(frozen=True)
class SparseSym:
    """Symmetric sparse matrix as COO triplets (full pattern, both triangles).

    Host-side normal form for SparseMatrixCSC / SparseMatrixCOO / Diagonal
    operands of the reference (src/structs.jl:303-317).
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    n: int

    def __post_init__(self):
        rows = np.asarray(self.rows, dtype=np.int64).reshape(-1)
        cols = np.asarray(self.cols, dtype=np.int64).reshape(-1)
        vals = np.asarray(self.vals, dtype=np.float64).reshape(-1)
        if not (rows.shape == cols.shape == vals.shape):
            raise ValueError("SparseSym: rows/cols/vals length mismatch")
        # coalesce duplicates (sum) and drop explicit zeros, like sparse()
        key = rows * self.n + cols
        order = np.argsort(key, kind="stable")
        key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
        uniq, inv = np.unique(key, return_inverse=True)
        summed = np.zeros(uniq.shape[0], dtype=np.float64)
        np.add.at(summed, inv, vals)
        keep = summed != 0.0
        uniq, summed = uniq[keep], summed[keep]
        object.__setattr__(self, "rows", (uniq // self.n).astype(np.int64))
        object.__setattr__(self, "cols", (uniq % self.n).astype(np.int64))
        object.__setattr__(self, "vals", summed)

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    def todense(self) -> np.ndarray:
        M = np.zeros((self.n, self.n))
        M[self.rows, self.cols] = self.vals
        return M

    def norm_fro(self) -> float:
        return float(np.linalg.norm(self.vals))

    def check_symmetric(self, tol: float = 0.0) -> bool:
        key = set(zip(self.rows.tolist(), self.cols.tolist()))
        d = {(int(i), int(j)): float(v) for i, j, v in zip(self.rows, self.cols, self.vals)}
        for (i, j) in key:
            if (j, i) not in key or abs(d[(i, j)] - d[(j, i)]) > tol:
                return False
        return True


MatrixLike = Union[SparseSym, SymLowRank, np.ndarray, "object"]


def as_operand(A: MatrixLike, n: Optional[int] = None) -> Union[SparseSym, SymLowRank]:
    """Normalize any supported operand to SparseSym or SymLowRank."""
    if isinstance(A, (SparseSym, SymLowRank)):
        return A
    if _sp is not None and _sp.issparse(A):
        coo = A.tocoo()
        return SparseSym(coo.row, coo.col, coo.data, coo.shape[0])
    if isinstance(A, np.ndarray):
        if A.ndim == 1:  # a diagonal, Diagonal-style convenience
            nn = A.shape[0]
            idx = np.arange(nn)
            return SparseSym(idx, idx, A, nn)
        if A.ndim == 2:
            r, c = np.nonzero(A)
            return SparseSym(r, c, A[r, c], A.shape[0])
    raise TypeError(
        "Supported operand types: SparseSym, SymLowRank, scipy sparse, numpy "
        f"array (reference: src/structs.jl:313-317). Got {type(A)!r}."
    )


def sparse_coo(rows, cols, vals, n) -> SparseSym:
    """COO constructor, the `super_sparse` analog (reference: test/problem.jl:5)."""
    return SparseSym(np.asarray(rows), np.asarray(cols), np.asarray(vals), int(n))


@dataclasses.dataclass(frozen=True)
class SDPProblem:
    """min <C, X>  s.t. <A_i, X> =/<= b_i,  X >= 0 (PSD).

    Equivalent of the reference's ``SDPData`` (src/structs.jl:150-180).
    ``constraint_types[i]`` False = equality, True = inequality (<=).
    """

    C: Union[SparseSym, SymLowRank]
    As: List[Union[SparseSym, SymLowRank]]
    b: np.ndarray
    constraint_types: np.ndarray  # bool, len m

    def __post_init__(self):
        C = as_operand(self.C)
        As = [as_operand(A) for A in self.As]
        b = np.asarray(self.b, dtype=np.float64).reshape(-1)
        m = len(As)
        if self.constraint_types is None:
            ct = np.zeros(m, dtype=bool)
        else:
            ct = np.asarray(self.constraint_types, dtype=bool).reshape(-1)
        if b.shape[0] != m or ct.shape[0] != m:
            raise ValueError("SDPProblem: len(As), len(b), len(constraint_types) must match")
        n = C.n
        for A in As:
            if A.n != n:
                raise ValueError("SDPProblem: all operands must share side dimension n")
        object.__setattr__(self, "C", C)
        object.__setattr__(self, "As", As)
        object.__setattr__(self, "b", b)
        object.__setattr__(self, "constraint_types", ct)

    @property
    def n(self) -> int:
        return self.C.n

    @property
    def m(self) -> int:
        return len(self.As)

    @property
    def has_inequalities(self) -> bool:
        return bool(self.constraint_types.any())


def make_problem(C, As: Sequence, b, constraint_types=None) -> SDPProblem:
    return SDPProblem(C, list(As), b, constraint_types)
