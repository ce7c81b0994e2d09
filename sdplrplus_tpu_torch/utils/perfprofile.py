"""Dolan–Moré performance profiles.

A numpy copy of the JAX package's ``utils/perfprofile.py``, the
equivalent of the reference's BenchmarkProfiles/CairoMakie plotting
(reference: exps/MyBenchmarkProfiles.jl:1-112): given a (n_problems,
n_solvers) cost matrix, compute the stairs data ρ_s(τ) and optionally
render with matplotlib when available.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def performance_profile(
    T: np.ndarray, tau_max: Optional[float] = None, npts: int = 200
) -> Tuple[np.ndarray, np.ndarray]:
    """Dolan–Moré profile.

    T[p, s] = cost of solver s on problem p (np.inf / nan = failure).
    Returns (taus [npts], rho [npts, n_solvers]) where
    rho[s](τ) = fraction of problems with T[p,s] <= τ · min_s' T[p,s'].
    """
    T = np.asarray(T, dtype=np.float64)
    T = np.where(np.isnan(T), np.inf, T)
    n_prob, n_solv = T.shape
    best = T.min(axis=1, keepdims=True)
    ratios = np.where(best > 0, T / best, np.where(T == 0, 1.0, np.inf))
    finite = ratios[np.isfinite(ratios)]
    if tau_max is None:
        tau_max = float(finite.max()) * 1.05 if finite.size else 2.0
    tau_max = max(tau_max, 1.0 + 1e-9)
    taus = np.logspace(0.0, np.log10(tau_max), npts)
    rho = np.empty((npts, n_solv))
    for s in range(n_solv):
        rho[:, s] = (ratios[:, s][None, :] <= taus[:, None]).mean(axis=1)
    return taus, rho


def plot_performance_profile(
    T: np.ndarray,
    solver_names: Sequence[str],
    out_path: str,
    title: str = "Performance profile",
    tau_max: Optional[float] = None,
):
    """Render the profile as stairs (matplotlib when available; otherwise
    writes the profile data as CSV next to ``out_path``)."""
    taus, rho = performance_profile(T, tau_max=tau_max)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        for s, name in enumerate(solver_names):
            ax.step(taus, rho[:, s], where="post", label=name)
        ax.set_xscale("log")
        ax.set_xlabel(r"performance ratio $\tau$")
        ax.set_ylabel(r"fraction of problems $\rho(\tau)$")
        ax.set_ylim(0, 1.02)
        ax.set_title(title)
        ax.legend(loc="lower right")
        fig.tight_layout()
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
        return out_path
    except ImportError:
        csv_path = out_path.rsplit(".", 1)[0] + ".csv"
        header = "tau," + ",".join(solver_names)
        np.savetxt(
            csv_path,
            np.column_stack([taus, rho]),
            delimiter=",",
            header=header,
            comments="",
        )
        return csv_path
