"""A problem for the harness's interface tests only, shaped as the port's
``mu_conductance_ineq`` (the μ-conductance SDP with native inequalities):

    min ⟨L, X⟩  s.t.  ⟨Diag(d), X⟩ = 1,  ⟨ddᵀ, X⟩ = 0,
                      Xᵢᵢ ≤ ub,  −Xᵢᵢ ≤ −lb  (i = 1..n),  X ⪰ 0,

with d the degrees, vol G = Σd, ub = (1 − μ)/(μ·vol G), lb = μ/((1 − μ)·vol
G) and the trace bound n·ub. Every instance brings its own constraints
(they depend on its degrees), their types and a trace bound that depends
on it. ``certify`` works out plain readings and keeps each instance it was
handed; it is no certificate for inequality multipliers. ``certify_tf32``,
the problem's control, works out the same readings from TF32-rounded R, λ
and C, and keeps its instances apart."""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from portbench.instance import Entries, Instance, LowRank
from portbench.reference.tf32 import tf32

CERTIFIED = []    # the instances ``certify`` was handed, in order
CONTROLLED = []   # the instances ``certify_tf32`` was handed, in order


def formulation(A: sp.spmatrix, mu: float) -> Instance:
    A = sp.csr_matrix(A, dtype=np.float64)
    n = A.shape[0]
    d = np.asarray(A.sum(axis=1)).ravel()
    vol = float(d.sum())
    ub, lb = (1.0 - mu) / (mu * vol), mu / ((1.0 - mu) * vol)
    idx = np.arange(n)
    cons = [Entries(idx, idx, d), LowRank(d[:, None], np.ones(1))]
    cons += [Entries(np.array([i]), np.array([i]), np.ones(1))
             for i in range(n)]
    cons += [Entries(np.array([i]), np.array([i]), -np.ones(1))
             for i in range(n)]
    b = np.concatenate([[1.0, 0.0], np.full(n, ub), np.full(n, -lb)])
    types = np.arange(2 * n + 2) >= 2
    C = (sp.diags(d) - A).tocsr()
    return Instance(C, b, n * ub, cons, types, {"mu": mu})


def values(inst: Instance, R: np.ndarray) -> np.ndarray:
    """⟨Aᵢ, RRᵀ⟩ for every constraint."""
    out = []
    for a in inst.constraints:
        if isinstance(a, LowRank):
            out.append(float(np.sum(a.d * np.sum((a.B.T @ R) ** 2, axis=1))))
        else:
            out.append(float(np.sum(a.vals * np.einsum(
                "ij,ij->i", R[a.rows], R[a.cols]))))
    return np.array(out)


def certify(inst: Instance, R: np.ndarray, lam: np.ndarray) -> dict:
    CERTIFIED.append(inst)
    return readings(inst, R, lam)


def certify_tf32(inst: Instance, R: np.ndarray, lam: np.ndarray) -> dict:
    CONTROLLED.append(inst)
    C = inst.C
    C = sp.csr_matrix((tf32(C.data), C.indices, C.indptr), shape=C.shape)
    return readings(dataclasses.replace(inst, C=C),
                    tf32(R).astype(np.float64), tf32(lam).astype(np.float64))


def readings(inst: Instance, R: np.ndarray, lam: np.ndarray) -> dict:
    R = np.asarray(R, np.float64)
    vio = values(inst, R) - inst.b
    vio[inst.types] = np.maximum(vio[inst.types], 0.0)
    obj = float(np.sum(R * (inst.C @ R)))
    S = inst.C.toarray()
    for y, a in zip(np.asarray(lam, np.float64), inst.constraints):
        if isinstance(a, LowRank):
            S -= y * (a.B * a.d) @ a.B.T
        else:
            np.add.at(S, (a.rows, a.cols), -y * a.vals)
    bound = float(np.asarray(lam) @ inst.b + inst.trace_bound
                  * min(0.0, np.linalg.eigvalsh(S)[0]))
    return {"pinfeas": float(np.linalg.norm(vio) / np.linalg.norm(inst.b)),
            "obj": obj, "bound": bound,
            "gap": (obj - bound) / min(abs(obj), abs(bound))}
