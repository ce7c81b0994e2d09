"""Row, window and lane gathers: three hand-written CUDA kernels and their
plain PyTorch versions.

``gather_rows`` is the row take of the ELL SpMM (ops/spmm.py
``spmm_ell``): every C@X of the fast-diagonal engine and every S-matvec
of a Lanczos pass runs it once, over tier 1's and tier 2's column ids
together. With
``gather_window`` and ``gather_lanes`` the three kernels are also the
counterparts of the eight Pallas gather probes of the JAX package's
experiments (``exps/probe2.py``, ``probe3.py``, ``probe5.py``,
``probe_gather.py``; sdplrplus_tpu_torch/probes.py calls them at the
probes' shapes):

  gather_rows(X, idx, q)   out[e·q + j] = X[idx[e]·q + j], j < q
                           (P1 _full_take_call, P2 _sublane_take_call,
                           P3 _pallas_take_call with q = 1; P4 _dma_gather
                           with q = rows_per_dma)
  gather_window(X, wins, offs, span, bucket)
                           out[t·bucket + j] = X[wins[t]·span + offs[t·bucket + j]]
                           (P5 _onehot_call, P6 _pallas_onehot_call)
  gather_lanes(X, idx)     out[s, l] = X[s, idx[s, l]]
                           (P7 _lane_gather_call, P8 _lane_gather_grid)

The kernels are ``csrc/gather.cu`` (CUDA C++ for sm_90a, plain C
interface, loaded with ``ctypes``; built at first use by
``utils/build.py``); its head says what bounds them (bytes: indices read,
rows read, output written) and what the design does about it. On a CUDA
tensor each wrapper launches its kernel, counts the launch
(``ROWS.launches``, ``WINDOW.launches``, ``LANES.launches``) and raises on
a device, dtype, shape or contiguity it does not take, or on a launch
error. On a CPU tensor it runs the plain version. It never falls back from
one to the other. A gather is exact, so kernel and plain version agree
bit for bit on indices inside X; an index outside it (negative ones
included) gives NaN in the kernel's output, where the plain version raises
(or, for a negative index, counts from the end).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.build import CudaLibrary

_FLOATS = (torch.float32, torch.float64)
_INTS = (torch.int32, torch.int64)


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_LIB = CudaLibrary("gather.cu", {
    "gather_rows": [_P, _LL, _P, _P, _LL, _I, _I, _I, _I, _P],
    "gather_window": [_P, _LL, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "gather_lanes": [_P, _P, _P, _LL, _LL, _I, _I, _P],
}, "gather_error_string")


class GatherKernel:
    """One entry point of the gather library and its launch count
    (``launches``: one per kernel launch; nothing else adds to it)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    @property
    def built(self):
        return _LIB.built

    def launch(self, *args):
        _LIB.call(self.name, *args, what=f"{self.name} launch")
        self.launches += 1


ROWS = GatherKernel("gather_rows")
WINDOW = GatherKernel("gather_window")
LANES = GatherKernel("gather_lanes")
KERNELS = (ROWS, WINDOW, LANES)


def _check(name: str, X: torch.Tensor, *idx: torch.Tensor):
    if X.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got X on {X.device}")
    if X.dtype not in _FLOATS:
        raise TypeError(f"{name} gathers float32 or float64, got {X.dtype}")
    if X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"{name} takes a contiguous 2-D X, got "
                         f"{tuple(X.shape)} with strides {X.stride()}")
    for i in idx:
        if i.device != X.device:
            raise ValueError(f"{name}: indices on {i.device}, X on "
                             f"{X.device}")
        if i.dtype not in _INTS:
            raise TypeError(f"{name} takes int32 or int64 indices, got "
                            f"{i.dtype}")
        if i.dtype != idx[0].dtype:
            raise TypeError(f"{name}: index tensors of one dtype, got "
                            f"{[j.dtype for j in idx]}")
        if not i.is_contiguous():
            raise ValueError(f"{name} takes contiguous indices")


def _stream(x: torch.Tensor) -> int:
    """The handle of the current stream on x's card (the raw query: a
    ``torch.cuda.Stream`` object per launch costs the host several µs)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


# ---- plain versions ---------------------------------------------------------

def gather_rows_plain(X: torch.Tensor, idx: torch.Tensor,
                      rows_per_index: int = 1) -> torch.Tensor:
    """X[idx] for q = 1; rows idx[e]·q + j, j < q, for q = rows_per_index."""
    q = int(rows_per_index)
    idx = idx.reshape(-1).long()
    if q == 1:
        return X[idx]
    rows = idx[:, None] * q + torch.arange(q, device=idx.device,
                                           dtype=idx.dtype)[None, :]
    return X[rows.reshape(-1)]


def gather_window_plain(X: torch.Tensor, wins: torch.Tensor,
                        offs: torch.Tensor, span: int,
                        bucket: int) -> torch.Tensor:
    """X[wins[t]·span + offs[t·bucket + j]] for every tile t, j < bucket."""
    rows = (torch.repeat_interleave(wins.reshape(-1).long(), int(bucket))
            * int(span) + offs.reshape(-1).long())
    return X[rows]


def gather_lanes_plain(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """torch.gather(X, 1, idx): out[s, l] = X[s, idx[s, l]]."""
    return torch.gather(X, 1, idx.long())


# ---- wrappers ------------------------------------------------------------------

def gather_rows(X: torch.Tensor, idx: torch.Tensor,
                rows_per_index: int = 1) -> torch.Tensor:
    """(E·q, r) rows of X (N, r): out[e·q + j] = X[idx[e]·q + j] for the
    E entries of the 1-D ``idx`` and j < q = ``rows_per_index``."""
    q = int(rows_per_index)
    if q < 1:
        raise ValueError(f"rows_per_index must be >= 1, got {q}")
    if X.device.type != "cuda":
        return gather_rows_plain(X, idx, q)
    _check("gather_rows", X, idx)
    if idx.dim() != 1:
        raise ValueError(f"gather_rows takes 1-D indices, got "
                         f"{tuple(idx.shape)}")
    E, r = idx.shape[0], X.shape[1]
    out = torch.empty((E * q, r), dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    ROWS.launch(X.data_ptr(), X.shape[0], idx.data_ptr(), out.data_ptr(),
                E, r, q, int(X.dtype == torch.float64),
                int(idx.dtype == torch.int64), _stream(X))
    return out


def gather_window(X: torch.Tensor, wins: torch.Tensor, offs: torch.Tensor,
                  span: int, bucket: int) -> torch.Tensor:
    """(T·bucket, r) rows: tile t takes the rows wins[t]·span + offs of its
    ``bucket`` offsets (``offs`` of shape (T, bucket) or (T·bucket,))."""
    if X.device.type != "cuda":
        return gather_window_plain(X, wins, offs, span, bucket)
    _check("gather_window", X, wins, offs)
    T, r = wins.numel(), X.shape[1]
    if wins.dim() != 1 or offs.numel() != T * int(bucket):
        raise ValueError(f"gather_window: wins {tuple(wins.shape)} and offs "
                         f"{tuple(offs.shape)} do not make tiles of "
                         f"{bucket}")
    out = torch.empty((T * int(bucket), r), dtype=X.dtype, device=X.device)
    if out.numel() == 0:
        return out
    WINDOW.launch(X.data_ptr(), X.shape[0], wins.data_ptr(),
                  offs.data_ptr(), out.data_ptr(),
                  T * int(bucket), r, int(span), int(bucket),
                  int(X.dtype == torch.float64),
                  int(wins.dtype == torch.int64), _stream(X))
    return out


def gather_lanes(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(S, L) take along each row: out[s, l] = X[s, idx[s, l]]."""
    if X.device.type != "cuda":
        return gather_lanes_plain(X, idx)
    _check("gather_lanes", X, idx)
    if tuple(idx.shape) != tuple(X.shape):
        raise ValueError(f"gather_lanes: idx {tuple(idx.shape)} must have "
                         f"X's shape {tuple(X.shape)}")
    S, L = X.shape
    out = torch.empty_like(X)
    if out.numel() == 0:
        return out
    LANES.launch(X.data_ptr(), idx.data_ptr(), out.data_ptr(), S, L,
                 int(X.dtype == torch.float64), int(idx.dtype == torch.int64),
                 _stream(X))
    return out
