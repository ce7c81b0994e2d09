"""SDP problem generators.

TPU-native equivalents of the reference's problem builders
(reference: test/problem.jl:1-237 and the exps superset,
exps/problems.jl:1-341). Each returns (C, As, b[, constraint_types])
ready for ``sdplr`` / ``make_problem``: sparse operands as SparseSym
(COO), rank-1 couplings as SymLowRank.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ..problem import SparseSym, SymLowRank, sparse_coo


def _check_symmetric(A: sp.spmatrix):
    if (A != A.T).nnz != 0:
        raise ValueError("Only undirected graphs are supported.")


def _laplacian(A: sp.spmatrix) -> sp.csr_matrix:
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    return (sp.diags(d) - A).tocsr()


def maxcut(A: sp.spmatrix):
    """MaxCut SDP: min -¼⟨L, X⟩ s.t. Diag(X) = 1, X ⪰ 0
    (reference: test/problem.jl:16-30)."""
    A = sp.csr_matrix(A)
    _check_symmetric(A)
    n = A.shape[0]
    L = (-0.25) * _laplacian(A)
    C = SparseSym(*_coo(L), n)
    As = [sparse_coo([i], [i], [1.0], n) for i in range(n)]
    b = np.ones(n)
    return C, As, b


def lovasz_theta(A: sp.spmatrix):
    """Lovász-θ SDP: min -⟨11ᵀ, X⟩ s.t. X_ij = 0 ∀(i,j)∈E, Tr(X) = 1
    (reference: test/problem.jl:43-65). C is rank-1 SymLowRank."""
    A = sp.csr_matrix(A)
    _check_symmetric(A)
    n = A.shape[0]
    C = SymLowRank(np.ones((n, 1)), np.array([-1.0]))
    As = []
    b = []
    coo = A.tocoo()
    for i, j in zip(coo.row, coo.col):
        if i < j:
            As.append(sparse_coo([i, j], [j, i], [1.0, 1.0], n))
            b.append(0.0)
        elif i == j:
            As.append(sparse_coo([i], [i], [1.0], n))
            b.append(0.0)
    eye = np.arange(n)
    As.append(sparse_coo(eye, eye, np.ones(n), n))
    b.append(1.0)
    return C, As, np.array(b)


def minimum_bisection(A: sp.spmatrix):
    """MinBisection SDP: min ¼⟨L, X⟩ s.t. Diag(X) = 1, 1ᵀX1 = 0, X ⪰ 0
    (reference: test/problem.jl:78-94). The coupling 11ᵀ is SymLowRank."""
    A = sp.csr_matrix(A)
    _check_symmetric(A)
    n = A.shape[0]
    L = 0.25 * _laplacian(A)
    C = SparseSym(*_coo(L), n)
    As = [sparse_coo([i], [i], [1.0], n) for i in range(n)]
    b = list(np.ones(n))
    As.append(SymLowRank(np.ones((n, 1)), np.array([1.0])))
    b.append(0.0)
    return C, As, np.array(b)


def bipartite_matrix(A: sp.spmatrix) -> sp.csr_matrix:
    """[0 A; Aᵀ 0] lift (reference: test/problem.jl:96-100)."""
    m, n = A.shape
    return sp.bmat(
        [[sp.csr_matrix((m, m)), A], [A.T, sp.csr_matrix((n, n))]]
    ).tocsr()


def cutnorm(A: sp.spmatrix):
    """CutNorm SDP on the bipartite lift (reference: test/problem.jl:102-112)."""
    A = sp.csr_matrix(A)
    Cm = (-0.5) * bipartite_matrix(A)
    N = Cm.shape[0]
    C = SparseSym(*_coo(Cm), N)
    As = [sparse_coo([i], [i], [1.0], N) for i in range(N)]
    b = np.ones(N)
    return C, As, b


def mu_conductance_ub(volG, mu):
    return (1.0 - mu) / (mu * volG)


def mu_conductance_lb(volG, mu):
    return mu / ((1.0 - mu) * volG)


def mu_conductance(A: sp.spmatrix, mu: float):
    """μ-conductance SDP with the 3n slack lift, equality-only
    (reference: test/problem.jl:137-179)."""
    A = sp.csr_matrix(A)
    _check_symmetric(A)
    n = A.shape[0]
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    volG = float(d.sum())
    L = _laplacian(A)
    N = 3 * n

    As = []
    b = []

    # ⟨D, X⟩ = 1 (padded to 3n)
    idx = np.arange(n)
    As.append(sparse_coo(idx, idx, d, N))
    b.append(1.0)

    # ⟨ddᵀ, X⟩ = 0 as rank-1 SymLowRank on the lift
    padded_d = np.concatenate([d, np.zeros(2 * n)]).reshape(-1, 1)
    As.append(SymLowRank(padded_d, np.array([1.0])))
    b.append(0.0)

    ub = mu_conductance_ub(volG, mu)
    lb = mu_conductance_lb(volG, mu)

    for i in range(n):
        As.append(sparse_coo([i, i + n], [i, i + n], [1.0, 1.0], N))
        b.append(ub)
    for i in range(n):
        As.append(sparse_coo([i, i + 2 * n], [i, i + 2 * n], [1.0, -1.0], N))
        b.append(lb)

    ri, ci, vi = _coo(L)
    C = SparseSym(ri, ci, vi, N)
    return C, As, np.array(b)


def mu_conductance_ineq(A: sp.spmatrix, mu: float):
    """μ-conductance SDP with native inequality constraints, n×n
    (reference: test/problem.jl:196-236). Returns
    (C, As, b, constraint_types)."""
    A = sp.csr_matrix(A)
    _check_symmetric(A)
    n = A.shape[0]
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    volG = float(d.sum())
    L = _laplacian(A)
    ub = mu_conductance_ub(volG, mu)
    lb = mu_conductance_lb(volG, mu)

    As = []
    b = []
    ct = []

    idx = np.arange(n)
    As.append(sparse_coo(idx, idx, d, n))
    b.append(1.0)
    ct.append(False)

    As.append(SymLowRank(d.reshape(-1, 1), np.array([1.0])))
    b.append(0.0)
    ct.append(False)

    for i in range(n):
        As.append(sparse_coo([i], [i], [1.0], n))
        b.append(ub)
        ct.append(True)
    for i in range(n):
        As.append(sparse_coo([i], [i], [-1.0], n))
        b.append(-lb)
        ct.append(True)

    C = SparseSym(*_coo(L), n)
    return C, As, np.array(b), np.array(ct, dtype=bool)


def relaxed_maxcut(A: sp.spmatrix):
    """Relaxed MaxCut: min -¼⟨L, X⟩ s.t. 0.99 ≤ Diag(X) ≤ 1 via the 3n
    slack lift, equality-only (reference: exps/problems.jl:188-216)."""
    A = sp.csr_matrix(A)
    _check_symmetric(A)
    n = A.shape[0]
    L = (-0.25) * _laplacian(A)
    N = 3 * n
    ri, ci, vi = _coo(L)
    C = SparseSym(ri, ci, vi, N)
    As = []
    b = []
    for i in range(n):
        As.append(sparse_coo([i, i + n], [i, i + n], [1.0, 1.0], N))
        b.append(1.0)
    for i in range(n):
        As.append(sparse_coo([i, i + 2 * n], [i, i + 2 * n], [1.0, -1.0], N))
        b.append(0.99)
    return C, As, np.array(b)


def relaxed_maxcut_ineq(A: sp.spmatrix):
    """Relaxed MaxCut with native inequalities: min -¼⟨L, X⟩ s.t.
    Diag(X) ≤ 1 (n×n, no lift). Returns (C, As, b, constraint_types)."""
    A = sp.csr_matrix(A)
    _check_symmetric(A)
    n = A.shape[0]
    L = (-0.25) * _laplacian(A)
    C = SparseSym(*_coo(L), n)
    As = [sparse_coo([i], [i], [1.0], n) for i in range(n)]
    b = np.ones(n)
    ct = np.ones(n, dtype=bool)
    return C, As, b, ct


def mu_conductance_reformulated(A: sp.spmatrix, mu: float):
    """μ-conductance SDP, reformulated slack coupling on the 3n lift
    (reference: exps/problems.jl:233-279)."""
    A = sp.csr_matrix(A)
    _check_symmetric(A)
    n = A.shape[0]
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    volG = float(d.sum())
    L = _laplacian(A)
    N = 3 * n

    As = []
    b = []

    idx = np.arange(n)
    As.append(sparse_coo(idx, idx, d, N))
    b.append(1.0)

    padded_d = np.concatenate([d, np.zeros(2 * n)]).reshape(-1, 1)
    As.append(SymLowRank(padded_d, np.array([1.0])))
    b.append(0.0)

    ub = mu_conductance_ub(volG, mu)
    lb = mu_conductance_lb(volG, mu)

    for i in range(n):
        As.append(sparse_coo([i, i + n], [i, i + n], [1.0, 1.0], N))
        b.append(ub)
    for i in range(n):
        As.append(
            sparse_coo([i + n, i + 2 * n], [i + n, i + 2 * n], [1.0, 1.0], N)
        )
        b.append(ub - lb)

    ri, ci, vi = _coo(L)
    C = SparseSym(ri, ci, vi, N)
    return C, As, np.array(b)


def mu_conductance_native(A: sp.spmatrix, mu: float):
    """μ-conductance SDP, native-inequality n×n formulation with
    D-norm scaling (reference: exps/problems.jl:295-341). Returns
    (C, As, b, constraint_types)."""
    A = sp.csr_matrix(A)
    _check_symmetric(A)
    n = A.shape[0]
    d = np.asarray(A.sum(axis=1)).reshape(-1)
    volG = float(d.sum())
    L = _laplacian(A)
    ub = mu_conductance_ub(volG, mu)
    lb = mu_conductance_lb(volG, mu)
    D_norm = float(np.linalg.norm(d))  # Frobenius norm of Diagonal(d)
    dd_norm = float(np.linalg.norm(d) ** 2)

    As = []
    b = []
    ct = []

    idx = np.arange(n)
    As.append(sparse_coo(idx, idx, d, n))
    b.append(1.0)
    ct.append(False)

    As.append(SymLowRank(d.reshape(-1, 1), np.array([D_norm / dd_norm])))
    b.append(0.0)
    ct.append(False)

    for i in range(n):
        As.append(sparse_coo([i], [i], [D_norm], n))
        b.append(ub * D_norm)
        ct.append(True)
    for i in range(n):
        As.append(sparse_coo([i], [i], [-D_norm], n))
        b.append(-lb * D_norm)
        ct.append(True)

    C = SparseSym(*_coo(L), n)
    return C, As, np.array(b), np.array(ct, dtype=bool)


def _coo(M: sp.spmatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    coo = M.tocoo()
    return coo.row, coo.col, coo.data


def make_random_graph(n: int, p: float, seed: int = 0) -> sp.csr_matrix:
    """Erdős–Rényi-style helper mirroring the reference's test fixture
    (reference: test/runtests.jl:30-36): symmetrized uniform matrix
    thresholded at p, zero diagonal."""
    rng = np.random.default_rng(seed)
    Ad = rng.uniform(size=(n, n))
    Ad = (Ad + Ad.T) / 2.0
    Ad = (Ad > p).astype(np.float64)
    np.fill_diagonal(Ad, 0.0)
    return sp.csr_matrix(Ad)


def synthetic_graph(n: int, deg: int, seed: int = 1) -> sp.csr_matrix:
    """Seeded random graph with n vertices and about n·deg/2 undirected
    edges, the G(n, M)-style instance of the JAX package's scale runs
    (``synthetic_graph`` of its experiment script; SYN20K is
    ``synthetic_graph(20000, 16)``, 319,699 edges)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, n * deg)
    keep = rows != cols
    A = sp.csr_matrix(
        (np.ones(keep.sum()), (rows[keep], cols[keep])), shape=(n, n)
    )
    return A.maximum(A.T)


def synthetic_cycle_power(n: int, k: int) -> sp.csr_matrix:
    """Cycle power graph C_n^k: i ~ j iff 0 < |i-j| mod n ≤ k (the JAX
    package's experiment-script generator). With (k+1) | n its Lovász
    number is exactly θ = n/(k+1): the independent set {0, k+1, ...}
    gives a rank-1 feasible X with ⟨-11ᵀ, X⟩ = -n/(k+1), and the
    circulant dual matches, so θ solves carry an analytic anchor."""
    offs = np.arange(1, k + 1)
    rows = np.repeat(np.arange(n), k)
    cols = (rows + np.tile(offs, n)) % n
    A = sp.csr_matrix((np.ones(n * k), (rows, cols)), shape=(n, n))
    return A.maximum(A.T)


def synthetic_cliques(n: int, s: int) -> sp.csr_matrix:
    """Disjoint union of n/s cliques of size s (the JAX package's
    experiment-script generator). Its Lovász number is exactly θ = n/s
    (clique-cover number = independence number; one vertex per clique
    gives a rank-1 optimal X)."""
    K = n // s
    base = np.repeat(np.arange(K) * s, s * (s - 1))
    i_loc = np.tile(np.repeat(np.arange(s), s - 1), K)
    j_loc = np.tile(
        np.concatenate([np.delete(np.arange(s), i) for i in range(s)]), K)
    rows = base + i_loc
    cols = base + j_loc
    return sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))


def synthetic_local_graph(n: int, deg: int, window: int,
                          seed: int = 1) -> sp.csr_matrix:
    """Seeded ring-local random graph (the JAX package's experiment-script
    generator): each node draws ``deg`` neighbours within ±window. The
    locality of road networks, meshes and BFS-reordered graphs; the
    experiment CLI's ``--synthetic-kind local`` takes window = 4·deg."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    offs = rng.integers(1, window + 1, n * deg) * rng.choice(
        [-1, 1], n * deg)
    cols = (rows + offs) % n
    A = sp.csr_matrix((np.ones(n * deg), (rows, cols)), shape=(n, n))
    return A.maximum(A.T)
