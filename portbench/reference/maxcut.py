"""Plain float64 reference of the MaxCut SDP under the Gset protocol.

    min ⟨C, X⟩  s.t.  Xᵢᵢ = 1 (i = 1..n),  X ⪰ 0,   C = -¼·L(A)

(SDPLR+'s test/problem.jl; L is the weighted graph Laplacian.) The
constraint matrices are eᵢeᵢᵀ and b = 1, so the reference never builds
them: an instance's ``constraints`` are None. Everything here is
NumPy/SciPy in float64 and imports nothing of the solver under test.

A solve returns a factor R (X = RRᵀ) and multipliers λ. The reference
works out what they certify, whatever the solver claimed:

* ``pinfeas``: ‖diag(RRᵀ) − b‖₂ / ‖b‖₂, the protocol's relative primal
  infeasibility;
* ``feasible_objective``: ⟨C, R̂R̂ᵀ⟩ for the rows of R scaled to unit
  norm, a point that meets every constraint exactly, so an upper bound
  on the optimum;
* ``dual_bound``: ⟨λ, b⟩ + τ·min(0, λ_min(C − Diag(λ))) for the trace
  bound τ, a lower bound on the optimum by weak duality for any λ
  (λ_min by LAPACK, or bracketed from below to within 1e-9 at large n);
* ``rel_gap``: (upper − lower) / min(|upper|, |lower|).

``certify_tf32`` is the check's control (``control.py``): the same
readings from TF32 operands with float32 sums (``tf32.py``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..instance import Instance
from .tf32 import tf32

DENSE_EIG_MAX_N = 4096   # above it λ_min is bracketed by inertia counts
EIG_TOL = 1e-9           # width of that bracket (S's entries are O(1))


def formulation(A: sp.spmatrix) -> Instance:
    """The MaxCut SDP of the symmetric weighted adjacency A:
    C = -¼·(Diag(A·1) − A) as CSR, b = 1, the diagonal constraints
    (``constraints`` None), trace bound n."""
    A = sp.csr_matrix(A, dtype=np.float64)
    n = A.shape[0]
    deg = np.asarray(A.sum(axis=1)).ravel()
    C = (-0.25 * (sp.diags(deg) - A)).tocsr()
    C.sum_duplicates()
    C.eliminate_zeros()
    return Instance(C, np.ones(n), float(n))


def pinfeas(R: np.ndarray, b: np.ndarray) -> float:
    R = np.asarray(R, np.float64)
    return float(np.linalg.norm(np.einsum("ij,ij->i", R, R) - b)
                 / np.linalg.norm(b))


def feasible_objective(C: sp.csr_matrix, R: np.ndarray,
                       b: np.ndarray) -> float:
    R = np.asarray(R, np.float64)
    norms = np.sqrt(np.einsum("ij,ij->i", R, R))
    Rh = R * (np.sqrt(b) / norms)[:, None]
    return float(np.sum(Rh * (C @ Rh)))


def _positive_definite(M: sp.csc_matrix) -> bool:
    """Whether the symmetric M is positive definite: an LDLᵀ with
    diagonal pivots (SuperLU in symmetric mode, one permutation for rows
    and columns) has only positive pivots (Sylvester's law of inertia).
    A zero pivot, which no positive definite matrix has, shows up as an
    exactly singular factor or as an off-diagonal pivot."""
    try:
        lu = spla.splu(M, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0.0,
                       options={"SymmetricMode": True})
    except RuntimeError:
        return False
    return bool((lu.perm_r == lu.perm_c).all()
                and (lu.U.diagonal() > 0).all())


def min_eig(S) -> float:
    """Least eigenvalue of the symmetric S (sparse), in float64. Above
    DENSE_EIG_MAX_N: a Lanczos Ritz value θ (never below λ_min) gives the
    start, and S − σI positive definite or not places λ_min above or below
    σ; the result is the lower end of a bracket [lo, lo + EIG_TOL] that
    holds λ_min (to the factorization's rounding, ~1e-15 here)."""
    n = S.shape[0]
    if n <= DENSE_EIG_MAX_N:
        return float(np.linalg.eigvalsh(S.toarray())[0])
    S = sp.csc_matrix(S)
    eye = sp.identity(n, format="csc")
    v0 = np.random.default_rng(0).standard_normal(n)
    theta = float(spla.eigsh(S, k=1, which="SA", tol=1e-6, ncv=min(n - 1, 40),
                             v0=v0, return_eigenvectors=False)[0])
    hi, step = theta, EIG_TOL
    lo = hi - step
    while not _positive_definite(S - lo * eye):
        hi, step = lo, 2.0 * step
        lo = hi - step
    while hi - lo > EIG_TOL:
        mid = 0.5 * (lo + hi)
        if _positive_definite(S - mid * eye):
            lo = mid
        else:
            hi = mid
    return lo


def dual_bound(C: sp.csr_matrix, lam: np.ndarray, b: np.ndarray,
               trace_bound: float) -> float:
    lam = np.asarray(lam, np.float64)
    S = C - sp.diags(lam)
    return float(lam @ b + trace_bound * min(0.0, min_eig(S)))


def rel_gap(upper: float, lower: float) -> float:
    return (upper - lower) / min(abs(upper), abs(lower))


def certify(inst: Instance, R: np.ndarray, lam: np.ndarray) -> dict:
    """The float64 readings of one solve's factor and multipliers."""
    C, b = inst.C, inst.b
    upper = feasible_objective(C, R, b)
    lower = dual_bound(C, lam, b, inst.trace_bound)
    return {"pinfeas": pinfeas(R, b), "obj": upper, "bound": lower,
            "gap": rel_gap(upper, lower)}


def certify_tf32(inst: Instance, R: np.ndarray, lam: np.ndarray) -> dict:
    """``certify``'s readings, each computed from TF32 operands with
    float32 sums; λ_min of the TF32-rounded S in float64."""
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
                  + np.float32(trace_bound * min(0.0, min_eig(S))))
    return {"pinfeas": pinfeas, "obj": upper, "bound": lower,
            "gap": rel_gap(upper, lower)}
