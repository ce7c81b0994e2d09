"""Progress printing (reference: src/myprint.jl:1-58).

The reference emits a PrettyTables row per print event; here a plain
fixed-width table with the same columns: dataset, major/local/total
iteration counts, ℒ, primal objective, σ, current tolerances, gradient
norm, primal infeasibility, best gap/dual value.
"""

from __future__ import annotations

_COLS = (
    ("dataset", 10),
    ("major", 6),
    ("local", 6),
    ("iter", 9),
    ("L_val", 13),
    ("obj", 13),
    ("sigma", 9),
    ("gtol_t", 9),
    ("ptol_t", 9),
    ("|grad|", 10),
    ("|pinfeas|", 10),
    ("min_gap", 10),
    ("max_dual", 13),
)


def print_heading(start: bool) -> None:
    if start:
        print("=" * 80)
        print(" SDPLRPlus-TPU : Burer-Monteiro low-rank SDP solver (PyTorch/CUDA port)")
        print("=" * 80)
        print(" | ".join(name.rjust(w) for name, w in _COLS))
    else:
        print("=" * 80)


def _fmt(x, w):
    if isinstance(x, str):
        return x.rjust(w)
    if isinstance(x, int):
        return str(x).rjust(w)
    return f"{x:.3e}".rjust(w)


def print_intermediate(
    dataset,
    majoriter,
    localiter,
    total_iter,
    L_val,
    obj,
    sigma,
    cur_gtol,
    cur_ptol,
    grad_norm,
    vio_norm,
    min_gap,
    max_dual,
) -> None:
    vals = (
        dataset[:10],
        majoriter,
        localiter,
        total_iter,
        L_val,
        obj,
        sigma,
        cur_gtol,
        cur_ptol,
        grad_norm,
        vio_norm,
        min_gap,
        max_dual,
    )
    print(" | ".join(_fmt(v, w) for v, (_, w) in zip(vals, _COLS)))
