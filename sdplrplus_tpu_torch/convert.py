"""Carry state from the JAX package into the port.

Each function takes one of the JAX package's objects given field by
field as host values (``{f: np.asarray(getattr(obj, f))}``, nested
objects as such dicts or as objects with those attributes) and returns
the port's object on ``device`` in ``dtype``. Nothing here imports JAX:
the caller turns the JAX arrays into numpy arrays. The tests use these to
feed identical state to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.device import (
    FLOAT_FIELDS, INT_FIELDS, STATIC_FIELDS, DeviceProblem, device_problem,
)
from .solver.inner import InnerCarry
from .solver.lbfgs import LBFGSState
from .solver.major import MajorCarry


def _get(obj, name, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def _np(x):
    return None if x is None else np.array(x)


def device_problem_from_numpy(fields, dtype, device="cpu") -> DeviceProblem:
    """The JAX ``DeviceProblem`` (ops/device.py) as the port's."""
    arrays = {f: _np(_get(fields, f)) for f in FLOAT_FIELDS + INT_FIELDS}
    lowrank = [(_np(_get(t, "B")), _np(_get(t, "d")), int(_get(t, "gid")))
               for t in _get(fields, "lowrank", ())]
    statics = {}
    for f in STATIC_FIELDS:
        v = _get(fields, f)
        statics[f] = tuple(int(g) for g in v) if isinstance(v, (tuple, list)) \
            else (v.item() if isinstance(v, np.ndarray) else v)
    return device_problem(arrays, lowrank, statics, dtype,
                          torch.device(device))


def _lbfgs_from_numpy(fields, dtype, device) -> LBFGSState:
    t = lambda f: torch.as_tensor(_np(_get(fields, f)), dtype=dtype,
                                  device=device)
    return LBFGSState(s_hist=t("s_hist"), y_hist=t("y_hist"), rho=t("rho"),
                      head=int(np.asarray(_get(fields, "head"))),
                      sty=t("sty"), yty=t("yty"))


def inner_carry_from_numpy(fields, dtype, device="cpu") -> InnerCarry:
    """The JAX ``InnerCarry`` (solver/inner.py) with its ``LBFGSState``
    and, on the fast-diagonal engine, the carried ``CX`` (None stays
    None)."""
    device = torch.device(device)
    t = lambda f: torch.as_tensor(_np(_get(fields, f)), dtype=dtype,
                                  device=device)
    CX = _get(fields, "CX")
    return InnerCarry(
        R=t("R"), G=t("G"), y_full=t("y_full"), vio_raw=t("vio_raw"),
        L_val=t("L_val"), grad_norm=t("grad_norm"),
        lbfgs=_lbfgs_from_numpy(_get(fields, "lbfgs"), dtype, device),
        steps=int(np.asarray(_get(fields, "steps"))),
        stagnated=bool(np.asarray(_get(fields, "stagnated"))),
        CX=None if CX is None else t("CX"),
    )


def major_carry_from_numpy(fields, dtype, device="cpu",
                           generator: torch.Generator | None = None
                           ) -> MajorCarry:
    """The JAX ``MajorCarry`` (solver/major.py). Its PRNG key has no torch
    counterpart: Lanczos start vectors come from ``generator`` (a fresh
    one seeded 0 when None) or are passed to ``major_chunk``."""
    device = torch.device(device)
    t = lambda f: torch.as_tensor(_np(_get(fields, f)), dtype=dtype,
                                  device=device)
    i = lambda f: int(np.asarray(_get(fields, f)))
    b = lambda f: bool(np.asarray(_get(fields, f)))
    return MajorCarry(
        ic=inner_carry_from_numpy(_get(fields, "ic"), dtype, device),
        lam=t("lam"), sigma=t("sigma"), cur_ptol=t("cur_ptol"),
        cur_gtol=t("cur_gtol"),
        generator=generator or torch.Generator().manual_seed(0),
        best_lam=t("best_lam"), max_dual=t("max_dual"), min_gap=t("min_gap"),
        last_gap=t("last_gap"), rankupd_cnt=i("rankupd_cnt"),
        majoriters=i("majoriters"), converged=b("converged"),
        rank_double=b("rank_double"), feas_count=i("feas_count"),
        dual_passes=i("dual_passes"),
    )
