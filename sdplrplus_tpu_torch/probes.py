"""The gather probes of the JAX package's experiments on the card.

Counterpart of the Pallas probe kernels in ``exps/probe2.py``,
``probe3.py``, ``probe5.py`` and ``probe_gather.py``, which measured the
row-gather designs behind the ELL SpMM (the JAX package's
``ops/spmm.py``). One function per Pallas probe, with its arguments; each
returns what the probe's kernel returns, through the hand-written CUDA
kernels of ``ops/gather.py`` on a CUDA tensor and their plain versions on
a CPU tensor. The probes' XLA-only parts (``f_matmul``, ``f_segsum``, the
einsum, striped and flat ELL forms) are not kernels and are not here.

``time_probes`` times the three kernels at the probes' own shapes
(N = 100,000 rows of X, T = 2¹⁹ gathered rows) against their plain
versions and one PyTorch library call, with CUDA events, in turns. A
time is the card's: the calls are queued behind a spin kernel, so the
host's cost of launching them is not in it. ``call_ms`` times one call
of each from the host's side, launch cost included, as the solver's
host loop pays it. The bound counts each input once (indices and X) and
the output once at the HBM rate: X (6.4 MB at r = 16) stays in the 50 MB
L2, so the rows gathered from it are L2 hits, not HBM traffic.
"""

from __future__ import annotations

import statistics

import torch

from .ops.gather import (
    gather_lanes, gather_lanes_plain, gather_rows, gather_rows_plain,
    gather_window, gather_window_plain,
)
from .utils.timing import PEAK_BYTES_PER_S

N = 100_000          # rows of X in every probe
T = 1 << 19          # rows gathered per call (probe5.py: 1 << 18)
TT = 512             # probe_gather.py's one-hot tile


# ---- one function per Pallas probe kernel -----------------------------------

def onehot_call(X, wins, offs2d, r, span, bucket):
    """exps/probe2.py::_onehot_call (P5): out[t·bucket + j] =
    X[wins[t]·span + offs2d[t, j]], shape (ntiles·bucket, r)."""
    return gather_window(X, wins, offs2d.reshape(-1).contiguous(), span,
                         bucket)


def lane_gather_call(Xt, idx, sub, lanes):
    """exps/probe3.py::_lane_gather_call (P7): out[s, l] = Xt[s, idx[s, l]]
    on one (sub, lanes) tile."""
    return gather_lanes(Xt, idx)


def lane_gather_grid(Xbig, idxbig, sub, lanes, ntiles):
    """exps/probe3.py::_lane_gather_grid (P8): the lane gather over ntiles
    (sub, lanes) row tiles of a (sub·ntiles, lanes) array."""
    return gather_lanes(Xbig, idxbig)


def sublane_take_call(Xt, idx, rows, out_rows, r):
    """exps/probe3.py::_sublane_take_call (P2): Xt[idx] on one (rows, r)
    tile, (out_rows, r)."""
    return gather_rows(Xt, idx.reshape(-1))


def full_take_call(X, idx, r):
    """exps/probe3.py::_full_take_call (P1): X[idx] on the whole X."""
    return gather_rows(X, idx.reshape(-1))


def dma_gather(X, idx, r, nslot=8, rows_per_dma=1):
    """exps/probe5.py::_dma_gather (P4): out[e·q + j] = X[idx[e]·q + j] for
    the first E = len(idx) // q indices, q = rows_per_dma. ``nslot`` is the
    TPU kernel's DMA ring depth and has no counterpart here."""
    q = int(rows_per_dma)
    E = idx.shape[0] // q
    return gather_rows(X, idx[:E].contiguous(), q)


def pallas_take_call(X, idx, r):
    """exps/probe_gather.py::_pallas_take_call (P3): X[idx], (len(idx), r)."""
    return gather_rows(X, idx.reshape(-1))


def pallas_onehot_call(X, wins, offs, r):
    """exps/probe_gather.py::_pallas_onehot_call (P6): 128-row windows and
    tiles of TT = 512 offsets: out[t·512 + j] = X[wins[t]·128 + offs[t·512
    + j]] for the len(offs) // 512 tiles."""
    ntiles = offs.numel() // TT
    return gather_window(X, wins[:ntiles].contiguous(), offs, 128, TT)


# ---- timing at the probes' shapes ---------------------------------------------

def _ms(fn, reps: int) -> float:
    """Device ms of one call: ``reps`` calls queued behind a spin kernel
    (so they run back to back on the card, whatever the host's cost of
    launching them), between two CUDA events, over reps. One warm-up call
    first."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e5) * reps)   # ~0.2 ms of spinning per call
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def call_ms(fn, reps: int = 20) -> float:
    """Median ms of one call from an idle card, the host's launch cost
    included (CUDA events around each call)."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def time_in_turns(kernel, plain, library=None, reps: int = 20) -> dict:
    """Device medians (ms) of the kernel, its plain version and the library
    call, timed in turns plain, kernel, library, library, kernel, plain,
    and the host-inclusive ``call_ms`` of each (``<who>_call_ms``), in the
    same turns."""
    fns = {"kernel": kernel, "plain": plain, "library": library}
    got = {w: [] for w in fns}
    calls = {w: [] for w in fns}
    for who in ("plain", "kernel", "library", "library", "kernel", "plain"):
        if fns[who] is not None:
            got[who].append(_ms(fns[who], reps))
            calls[who].append(call_ms(fns[who], reps))
    out = {f"{w}_ms": (statistics.median(v) if v else None)
           for w, v in got.items()}
    out.update({f"{w}_call_ms": (statistics.median(v) if v else None)
                for w, v in calls.items()})
    return out


def bound_ms(nbytes: float) -> float:
    """The least time the card needs to move ``nbytes`` at 3.35 TB/s."""
    return 1e3 * nbytes / PEAK_BYTES_PER_S


def gather_bytes(n_idx: int, x_elems: int, out_elems: int,
                 idx_bytes: int = 4, val_bytes: int = 4) -> int:
    """Bytes a gather must move: each index read once, X read once, the
    output written once (a row gathered twice is read from L2, not
    HBM)."""
    return n_idx * idx_bytes + (x_elems + out_elems) * val_bytes


def probe_inputs(device="cuda", seed: int = 0) -> dict:
    """The probes' inputs, drawn from ``seed``: X (N, r) for r = 16 and 32,
    row ids (T,), window ids and offsets for span/bucket (128, 512) and
    (1024, 512), and the (8·512, 1024) lane-gather grid."""
    g = torch.Generator().manual_seed(seed)
    to = lambda x: x.to(device)
    inp = {f"X{r}": to(torch.randn((N, r), generator=g)) for r in (16, 32)}
    inp["idx"] = to(torch.randint(0, N, (T,), generator=g, dtype=torch.int32))
    inp["idx_dma8"] = to(torch.randint(0, N // 8, (T // 8,), generator=g,
                                       dtype=torch.int32))
    for span in (128, 1024):
        inp[f"wins{span}"] = to(torch.randint(0, N // span, (T // 512,),
                                              generator=g,
                                              dtype=torch.int32))
        inp[f"offs{span}"] = to(torch.randint(0, span, (T,), generator=g,
                                              dtype=torch.int32))
    sub, lanes = 8, 1024
    ntiles = T // lanes
    inp["lanesX"] = to(torch.randn((sub * ntiles, lanes), generator=g))
    inp["lanesI"] = to(torch.randint(0, lanes, (sub * ntiles, lanes),
                                     generator=g, dtype=torch.int32))
    return inp


def time_probes(reps: int = 20, seed: int = 0) -> list:
    """CUDA-event times of the three kernels at the probes' shapes, with
    their bounds (``gather_bytes``: indices, X and output, each once).
    Each row: probe, kernel, shape, kernel/plain/library ms, bound ms."""
    inp = probe_inputs("cuda", seed)
    rows = []
    for r in (16, 32):
        X, idx = inp[f"X{r}"], inp["idx"]
        idx64 = idx.long()
        t = time_in_turns(lambda: gather_rows(X, idx),
                          lambda: gather_rows_plain(X, idx),
                          lambda: torch.index_select(X, 0, idx64), reps)
        rows.append(dict(probe="P1/P3 row take", kernel="gather_rows",
                         shape=f"X ({N}, {r}) f32, idx ({T},)",
                         bound_ms=bound_ms(gather_bytes(T, N * r, T * r)),
                         **t))
        wins, offs = inp["wins128"], inp["offs128"]
        t = time_in_turns(
            lambda: gather_window(X, wins, offs, 128, 512),
            lambda: gather_window_plain(X, wins, offs, 128, 512), None, reps)
        rows.append(dict(probe="P5/P6 window select span 128 bucket 512",
                         kernel="gather_window",
                         shape=f"X ({N}, {r}) f32, offs ({T},)",
                         bound_ms=bound_ms(gather_bytes(
                             T // 512 + T, N * r, T * r)), **t))
        wins, offs = inp["wins1024"], inp["offs1024"]
        t = time_in_turns(
            lambda: gather_window(X, wins, offs, 1024, 512),
            lambda: gather_window_plain(X, wins, offs, 1024, 512), None,
            reps)
        rows.append(dict(probe="P5 window select span 1024 bucket 512",
                         kernel="gather_window",
                         shape=f"X ({N}, {r}) f32, offs ({T},)",
                         bound_ms=bound_ms(gather_bytes(
                             T // 512 + T, N * r, T * r)), **t))
    X, idx8 = inp["X16"], inp["idx_dma8"]
    rows8 = (idx8.long()[:, None] * 8 + torch.arange(
        8, device=idx8.device)[None, :]).reshape(-1)
    t = time_in_turns(lambda: gather_rows(X, idx8, 8),
                      lambda: gather_rows_plain(X, idx8, 8),
                      lambda: torch.index_select(X, 0, rows8), reps)
    rows.append(dict(probe="P4 DMA gather, 8 rows per index",
                     kernel="gather_rows",
                     shape=f"X ({N}, 16) f32, idx ({T // 8},) x 8 rows",
                     bound_ms=bound_ms(gather_bytes(T // 8, N * 16,
                                                    T * 16)), **t))
    Xl, Il = inp["lanesX"], inp["lanesI"]
    Il64 = Il.long()
    t = time_in_turns(lambda: gather_lanes(Xl, Il),
                      lambda: gather_lanes_plain(Xl, Il),
                      lambda: torch.gather(Xl, 1, Il64), reps)
    S, L = Xl.shape
    rows.append(dict(probe="P7/P8 lane gather grid", kernel="gather_lanes",
                     shape=f"({S}, {L}) f32 / i32",
                     bound_ms=bound_ms(gather_bytes(S * L, S * L, S * L)),
                     **t))
    return rows
