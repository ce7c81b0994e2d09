"""External-model adapter: run the solver on user-supplied operators.

Counterpart of the JAX package's ``adapter.py`` (reference:
src/lowrankopt.jl:1-135, the disabled LowRankOpt/NLPModels adapter). A
``CustomModel`` carries torch callables, and the core operators
(ops/forward.py ``A_uu``, ``A_uv``, ``A_linesearch``; ops/adjoint.py
``apply_S``, ``gradient``) dispatch to them, so the torch inner loop, the
Lanczos dual bound and both outer drivers run unchanged on any model that
can express

    A_uu(U)        -> (m+1,)      slot m = ⟨C, UUᵀ⟩
    A_uv(U, V)     -> (m+1,)      𝒜((UVᵀ+VUᵀ)/2), slot m likewise
    apply_S(y, X)  -> (n_pad, r)  S·X with S = Σᵢ yᵢAᵢ + y_m·C

on tensors of the model's dtype and device. ``solve_model``
(solver/outer.py) solves one. The fields after the callables tell the
solver's engine selection that a model is none of the compiled engines
(no dense C, no entry mask, no diagonal structure, no low-rank terms).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CustomModel:
    b: torch.Tensor            # (m,)
    lam_ub: torch.Tensor       # (m,) 0 on inequalities, +inf on equalities
    vio_lb: torch.Tensor       # (m,) 0 on inequalities, -inf on equalities
    n: int = 0
    m: int = 0
    n_pad: int = 0
    normC: float = 1.0
    normb: float = 1.0
    has_inequalities: bool = False
    fn_A_uu: Optional[Callable] = None
    fn_A_uv: Optional[Callable] = None
    fn_apply_S: Optional[Callable] = None
    # what the engine selection reads of a compiled DeviceProblem
    C_dense: None = None
    ew_c2: None = None
    all_cons_diagonal: bool = False
    ls_eligible: bool = False
    entry_trace_cert: bool = False
    diag_identity: bool = False
    lowrank: tuple = ()
    wide_gids: tuple = ()
    spmd: None = None          # an external model runs on one device

    @property
    def dtype(self) -> torch.dtype:
        return self.b.dtype

    @property
    def device(self) -> torch.device:
        return self.b.device


def make_custom_model(*, n, b, fn_A_uu, fn_A_uv, fn_apply_S,
                      constraint_types=None, normC=1.0, normb=None,
                      dtype=torch.float32, n_pad=None,
                      device="cuda") -> CustomModel:
    """A CustomModel with its vectors on ``device`` (the card unless
    ``device="cpu"`` is given) in ``dtype``. ``constraint_types[i]`` True
    makes constraint i an inequality ⟨Aᵢ, X⟩ ≤ bᵢ."""
    b = np.asarray(b, dtype=np.float64)
    m = b.shape[0]
    ct = (np.zeros(m, dtype=bool) if constraint_types is None
          else np.asarray(constraint_types, dtype=bool))
    if normb is None:
        normb = float(np.linalg.norm(b))
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=torch.device(device))
    return CustomModel(
        b=t(b), lam_ub=t(np.where(ct, 0.0, np.inf)),
        vio_lb=t(np.where(ct, 0.0, -np.inf)), n=int(n), m=m,
        n_pad=int(n_pad if n_pad is not None else n), normC=float(normC),
        normb=float(normb), has_inequalities=bool(ct.any()),
        fn_A_uu=fn_A_uu, fn_A_uv=fn_A_uv, fn_apply_S=fn_apply_S)


def dense_model(C, As, b, constraint_types=None, *, dtype=torch.float32,
                device="cuda") -> CustomModel:
    """A CustomModel from dense matrices: the analog of running the
    reference through the NLPModels path with dense Jacobian products. It
    holds (m+1) dense n×n matrices on the device, so it is for tests and
    tiny models."""
    C = np.asarray(C, dtype=np.float64)
    n = C.shape[0]
    stack = torch.as_tensor(
        np.stack([np.asarray(A, dtype=np.float64) for A in As] + [C]),
        dtype=dtype, device=torch.device(device))        # (m+1, n, n)

    def fn_A_uu(U):
        return torch.einsum("kij,ij->k", stack, U @ U.T)

    def fn_A_uv(U, V):
        return torch.einsum("kij,ij->k", stack, 0.5 * (U @ V.T + V @ U.T))

    def fn_apply_S(y_full, X):
        return torch.einsum("k,kij->ij", y_full, stack) @ X

    return make_custom_model(
        n=n, b=b, fn_A_uu=fn_A_uu, fn_A_uv=fn_A_uv, fn_apply_S=fn_apply_S,
        constraint_types=constraint_types, normC=float(np.linalg.norm(C)),
        dtype=dtype, device=device)
