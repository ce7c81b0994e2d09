"""Shared helpers for the port's experiment drivers (``exps/run.py``,
``exps/sweep.py`` of this package).

Counterpart of the JAX package's ``exps/common.py``: one result-JSON
schema, so every artifact carries the provenance and honesty fields of
the benchmark protocol: ``timed_out`` (the run hit its wall-clock cap;
its gap fields are then a time slice, not a converged certificate),
``seed``, ``commit`` (the checkout's HEAD at run time), ``inner_engine``,
``maxtime``, ``n`` and the (problem, graph) identity. Where the JAX
package asks JAX for its backend, the port records the device the solve
ran on: ``backend`` ("cuda" or "cpu"), ``device`` (the card's name, or
"cpu") and, on the card, ``power_limit`` as nvidia-smi reports it (a
card set below its maximum runs slower under load).
"""

from __future__ import annotations

import functools
import os
import subprocess

import torch

from ..utils.cache import enable_compile_cache

# the checkout holding this package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the experiment scripts' output tree; its _live subtree is git-ignored
OUTPUT = os.path.join(REPO, "exps", "output")

SHORT_KEYS = [
    "grad_norm", "primal_vio", "obj", "obj_feasible", "rel_duality_gap",
    "min_duality_gap", "totaltime", "dual_lanczos_time", "primaltime",
    "preprocess_time", "iter", "majoriter", "ptol", "objtol", "fprec",
    "callback_res", "rankupd_tol", "r", "dtype",
    # honesty / provenance fields
    "timed_out", "inner_engine", "dual_bounds_computed", "dual_passes",
]


def setup_cache() -> str:
    """Keep the port's nvcc builds across runs (utils/cache.py)."""
    return enable_compile_cache()


def repo_commit() -> str:
    try:
        return subprocess.run(
            ["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


@functools.lru_cache(maxsize=None)
def nvidia_smi_line(index: int = 0) -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    reports them (e.g. "NVIDIA H100 80GB HBM3, 700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_info(device) -> dict:
    """{backend, device, power_limit} of a torch device: on the card its
    name and power limit (nvidia-smi), on the CPU "cpu" and None."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dict(backend="cpu", device="cpu", power_limit=None)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return dict(backend="cuda", device=torch.cuda.get_device_name(index),
                power_limit=nvidia_smi_line(index).split(",")[-1].strip())


def short_result(res: dict, *, problem: str, graph: str, n: int,
                 seed: int, maxtime: float, device) -> dict:
    short = {k: res.get(k) for k in SHORT_KEYS}
    short.update(
        problem=problem, graph=graph, n=n, seed=seed, maxtime=maxtime,
        commit=repo_commit(), solver="SDPLRPlus-torch",
        **device_info(device),
    )
    return short
