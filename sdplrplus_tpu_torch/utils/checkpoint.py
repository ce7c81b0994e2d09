"""Checkpoint / resume.

A copy of the JAX package's numpy-only ``utils/checkpoint.py``, with the
same ``.npz`` format, so a checkpoint written by either package resumes
in the other. The reference has no in-solver checkpointing; its restart
state is the result dict (Rt, λ, σ, r) plus init_func warm-starting
(reference: src/sdplr.jl:426-448, src/options.jl:19-20). Here that state
is written at the major-iteration boundary as a .npz file, and
``warm_start_from`` turns a checkpoint or a result dict into an
init_func.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_checkpoint(path: str, *, R: np.ndarray, lam: np.ndarray,
                    sigma: float, r: int, majoriter: int, total_iter: int,
                    extra: Optional[dict] = None) -> None:
    payload = dict(
        R=np.asarray(R, dtype=np.float64),
        lam=np.asarray(lam, dtype=np.float64),
        sigma=np.float64(sigma),
        r=np.int64(r),
        majoriter=np.int64(majoriter),
        total_iter=np.int64(total_iter),
    )
    if extra:
        for k, v in extra.items():
            payload["extra_" + k] = np.asarray(v)
    np.savez(path, **payload)


def load_checkpoint(path: str) -> dict:
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    out["sigma"] = float(out["sigma"])
    out["r"] = int(out["r"])
    out["majoriter"] = int(out["majoriter"])
    out["total_iter"] = int(out["total_iter"])
    return out


def warm_start_from(state) -> tuple:
    """(init_func, init_args, r, sigma0) from a checkpoint dict or a
    solver result dict, for SolverConfig (src/options.jl:19-20). If the
    requested rank exceeds the stored one (after rank doubling), the
    factor is padded on the rank axis with small random columns."""
    R = np.asarray(state.get("R", state.get("Rt", None)))
    if R is None:
        raise ValueError("state has no factor R/Rt")
    if "R" not in state and "Rt" in state:
        R = R.T
    lam = np.asarray(state.get("lam", state.get("lambda")))
    sigma = float(state.get("sigma", 2.0))
    r = int(R.shape[1])

    def init_func(prob, want_r):
        n = prob.n
        R0 = np.zeros((n, want_r))
        R0[:, : min(r, want_r)] = R[:n, : min(r, want_r)]
        if want_r > r:  # fresh random directions for the new columns
            rng = np.random.default_rng(0)
            R0[:, r:] = 0.01 * rng.uniform(-1, 1, size=(n, want_r - r))
        return R0, lam.copy()

    return init_func, (), r, sigma
