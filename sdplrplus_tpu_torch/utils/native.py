"""ctypes loader for the native host-side core (native/compiler_core.cpp).

The XLA/Pallas graph owns all device compute; this module owns the O(nnz)
HOST data path the reference runs as compiled Julia (reference:
src/preprocess.jl:24-169, exps/data_preprocess.jl): text edge-list
ingestion and ELL group-packing for the problem compiler.

The shared library is built once with g++ into a cache directory and
memoized; every entry point has a pure-numpy fallback so the framework
works on machines without a toolchain (``native_available()`` reports
which path is active).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sysconfig
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "compiler_core.cpp",
)


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SRC):
        return None
    from .build import build_dir

    cache_dir = build_dir()
    os.makedirs(cache_dir, exist_ok=True)
    tag = f"{os.path.getmtime(_SRC):.0f}_{os.path.getsize(_SRC)}"
    so = os.path.join(cache_dir, f"compiler_core_{tag}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so)
        except (subprocess.CalledProcessError, FileNotFoundError, OSError):
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    i64, i32, f64, cchar = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_char_p,
    )
    pi64 = ctypes.POINTER(ctypes.c_int64)
    lib.parse_edges.restype = i64
    lib.parse_edges.argtypes = [cchar, i64, i64, pi64, pi64, f64]
    lib.count_lines.restype = i64
    lib.count_lines.argtypes = [cchar, i64]
    lib.ell_group_pack.restype = i64
    lib.ell_group_pack.argtypes = [pi64, i32, f64, i64, i64, i64, i32, f64, i32]
    lib.ell_group_pack2.restype = i64
    lib.ell_group_pack2.argtypes = [pi64, i32, f64, f64, i64, i64, i64,
                                    i32, f64, f64, i32]
    lib.group_counts.restype = i64
    lib.group_counts.argtypes = [pi64, i64, i64, i32]
    return lib


def native_available() -> bool:
    return _lib() is not None


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _pf(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


# ---------------------------------------------------------------------------
# edge-list parsing
# ---------------------------------------------------------------------------

def parse_edges(text: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse "u v [w]" lines from ``text`` -> (I, J, W) arrays (raw ids).
    Comment lines (#, %) are skipped. Native when available, else numpy."""
    lib = _lib()
    if lib is not None:
        cap = lib.count_lines(text, len(text))
        I = np.empty(cap, dtype=np.int64)
        J = np.empty(cap, dtype=np.int64)
        W = np.empty(cap, dtype=np.float64)
        m = lib.parse_edges(text, len(text), cap, _p64(I), _p64(J), _pf(W))
        if m >= 0:
            return I[:m].copy(), J[:m].copy(), W[:m].copy()
    # numpy fallback
    Is, Js, Ws = [], [], []
    for line in text.decode("utf-8", "replace").splitlines():
        s = line.strip()
        if not s or s[0] in "#%":
            continue
        parts = s.split()
        if len(parts) < 2:
            continue
        try:
            Is.append(int(parts[0]))
            Js.append(int(parts[1]))
            Ws.append(float(parts[2]) if len(parts) > 2 else 1.0)
        except ValueError:
            continue
    return (np.asarray(Is, np.int64), np.asarray(Js, np.int64),
            np.asarray(Ws, np.float64))


# ---------------------------------------------------------------------------
# ELL group packing
# ---------------------------------------------------------------------------

def group_ell_pack(gid: np.ndarray, col: np.ndarray, val: np.ndarray,
                   n_groups: int, width: Optional[int] = None,
                   fill_col: int = 0,
                   val2: Optional[np.ndarray] = None):
    """Stable group-by-gid pack into (n_groups, W) ELL arrays.

    Returns (cols, vals[, vals2], counts). ``width=None`` auto-sizes W to
    the max group count (>= 1). Pad slots hold (fill_col, 0.0).
    """
    gid = np.ascontiguousarray(gid, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.float64)
    n = int(n_groups)
    lib = _lib()

    if width is None:
        if lib is not None:
            cnt0 = np.zeros(n, dtype=np.int32)
            width = max(int(lib.group_counts(_p64(gid), len(gid), n,
                                             _p32(cnt0))), 1)
        else:
            width = max(int(np.bincount(
                gid[(gid >= 0) & (gid < n)], minlength=max(n, 1)
            ).max()) if len(gid) else 1, 1)
    W = int(width)

    out_col = np.full((n, W), fill_col, dtype=np.int32)
    out_val = np.zeros((n, W), dtype=np.float64)
    counts = np.zeros(n, dtype=np.int32)
    if val2 is not None:
        val2 = np.ascontiguousarray(val2, dtype=np.float64)
        out_val2 = np.zeros((n, W), dtype=np.float64)
        if lib is not None:
            lib.ell_group_pack2(
                _p64(gid), _p32(col), _pf(val), _pf(val2), len(gid), n, W,
                _p32(out_col), _pf(out_val), _pf(out_val2), _p32(counts),
            )
        else:
            _py_pack(gid, col, [val, val2], n, W,
                     out_col, [out_val, out_val2], counts)
        return out_col, out_val, out_val2, counts

    if lib is not None:
        lib.ell_group_pack(
            _p64(gid), _p32(col), _pf(val), len(gid), n, W,
            _p32(out_col), _pf(out_val), _p32(counts),
        )
    else:
        _py_pack(gid, col, [val], n, W, out_col, [out_val], counts)
    return out_col, out_val, counts


def _py_pack(gid, col, vals, n, W, out_col, out_vals, counts):
    """Vectorized numpy fallback: stable sort by gid, rank within group."""
    ok = (gid >= 0) & (gid < n)
    g = gid[ok]
    order = np.argsort(g, kind="stable")
    gs = g[order]
    cs = col[ok][order]
    starts = np.searchsorted(gs, np.arange(n))
    rank = np.arange(len(gs)) - starts[gs]
    np.add.at(counts, gs, 1)
    keep = rank < W
    out_col[gs[keep], rank[keep]] = cs[keep]
    for v, out in zip(vals, out_vals):
        vo = v[ok][order]
        out[gs[keep], rank[keep]] = vo[keep]
