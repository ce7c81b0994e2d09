"""Faults planted under the timed path, for the tests and the readings
that show the check catches them (``control.py --fault``). Each is a
context manager; the harness runs unchanged inside it.

* ``state_unchanged``: every inner activation of the port (the torch
  loop's ``run_activation`` and K1's ``mega_chunk``) returns the factor
  it was given, its step budget spent, so a solve runs to its time limit;
* ``half_batch``: the port is handed C with a random half of the edges
  left out and the rest doubled, the sum over the kept half standing in
  for the whole (the reference keeps the true C);
* ``answer_altered``: one entry of each returned factor changes sign
  where the solve hands it back, after its claims were made.

Besides these, ``tf32`` runs the timed path in the precision below the
one the configurations state: the port's cuBLAS products on TF32 tensor
cores, and R, G and C·R rounded to TF32 after every inner activation
(the torch loop's and K1's), and the multipliers and factor rounded to
TF32 where each Lanczos dual bound (block or scalar) starts. A solve may
still certify at the protocol's 1e-2; its readings show which limit, if
any, a solver computing below float32 crosses.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import scipy.sparse as sp

from . import port

NAMES = ("state_unchanged", "half_batch", "answer_altered")
READINGS = NAMES + ("tf32",)


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _state_unchanged():
    from sdplrplus_tpu_torch.ops import megakernel
    from sdplrplus_tpu_torch.solver import major

    def activation(dp, ic, lam, sigma, cur_gtol, stag_tol, max_steps,
                   **kwargs):
        return dataclasses.replace(ic, steps=ic.steps + max(max_steps, 1))

    real_chunk = megakernel.mega_chunk

    def chunk(spec, r, m, pscale, data, R, lbfgs, *args, **kwargs):
        ic, vio = real_chunk(spec, r, m, pscale, data, R, lbfgs, *args,
                             **kwargs)
        return dataclasses.replace(ic, R=R), vio

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(major, "run_activation", activation))
    stack.enter_context(_patched(megakernel, "mega_chunk", chunk))
    return stack


def _half_batch():
    real = port.solve

    def solve(inst, As, solver, **kwargs):
        U = sp.triu(inst.C, 1).tocoo()
        keep = np.random.default_rng(U.nnz).random(U.nnz) < 0.5
        W = sp.coo_matrix((2.0 * U.data[keep], (U.row[keep], U.col[keep])),
                          shape=inst.C.shape)
        W = W + W.T
        deg = np.asarray(W.sum(axis=1)).ravel()
        return real(dataclasses.replace(inst, C=(W - sp.diags(deg)).tocsr()),
                    As, solver, **kwargs)

    return _patched(port, "solve", solve)


def _answer_altered():
    real = port.solve

    def solve(*args, **kwargs):
        res = real(*args, **kwargs)
        R = np.array(res["R"], dtype=np.float64)
        j = int(np.argmax(np.abs(R[0])))
        R[0, j] = -R[0, j]
        res["R"] = R
        return res

    return _patched(port, "solve", solve)


def round_tf32(x):
    """A torch tensor rounded to the nearest TF32 value (10 explicit
    mantissa bits, ties to even), in its own dtype."""
    import torch

    u = x.detach().to(torch.float32).contiguous().view(torch.int32)
    u = (u + 0x0FFF + ((u >> 13) & 1)) & -0x2000
    return u.view(torch.float32).to(x.dtype)


def _tf32():
    import torch

    from sdplrplus_tpu_torch.ops import megakernel
    from sdplrplus_tpu_torch.solver import major

    def rounded(ic):
        cx = None if ic.CX is None else round_tf32(ic.CX)
        return dataclasses.replace(ic, R=round_tf32(ic.R),
                                   G=round_tf32(ic.G), CX=cx)

    real_act, real_chunk = major.run_activation, megakernel.mega_chunk
    real_block = major.block_lanczos_min_eig
    real_scalar = major.lanczos_alpha_beta_impl

    def activation(*args, **kwargs):
        return rounded(real_act(*args, **kwargs))

    def chunk(*args, **kwargs):
        ic, vio = real_chunk(*args, **kwargs)
        return rounded(ic), vio

    def block(dp, y_full, generator, R, *args, **kwargs):
        return real_block(dp, round_tf32(y_full), generator, round_tf32(R),
                          *args, **kwargs)

    def scalar(dp, y_full, v0, *args, **kwargs):
        return real_scalar(dp, round_tf32(y_full), round_tf32(v0), *args,
                           **kwargs)

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(torch.backends.cuda.matmul, "allow_tf32",
                                 True))
    stack.enter_context(_patched(major, "run_activation", activation))
    stack.enter_context(_patched(megakernel, "mega_chunk", chunk))
    stack.enter_context(_patched(major, "block_lanczos_min_eig", block))
    stack.enter_context(_patched(major, "lanczos_alpha_beta_impl", scalar))
    return stack


def planted(name: str):
    return {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
            "answer_altered": _answer_altered, "tf32": _tf32}[name]()
