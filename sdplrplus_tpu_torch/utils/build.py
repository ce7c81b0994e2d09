"""Build directory and ``nvcc`` builds of the port's CUDA sources.

Every native artifact of the port (the CUDA kernels under ``csrc/`` and
the host compiler core ``native/compiler_core.cpp``) is built at first
use into one directory inside the checkout, ``sdplrplus_tpu_torch/_build``
(listed in ``.gitignore``; ``SDPLRPLUS_TORCH_BUILD`` overrides it).
Deleting that directory forces a rebuild.

CUDA sources have a plain C interface and are loaded with ``ctypes``:
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC``. A library is keyed by a hash of its source and flags, so an
edited source never loads a stale build. ``CudaLibrary`` is how a kernel
wrapper holds one: built and typed at first use, every entry point's
``cudaError_t`` turned into a RuntimeError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_dir() -> str:
    d = os.environ.get("SDPLRPLUS_TORCH_BUILD", os.path.join(_PKG, "_build"))
    os.makedirs(d, exist_ok=True)
    return d


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc") or "")
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from source at first use"
    )


class Built:
    """A loaded CUDA library with its build record."""

    def __init__(self, lib: ctypes.CDLL, path: str, log: str,
                 seconds: float, cached: bool):
        self.lib, self.path, self.log = lib, path, log
        self.seconds, self.cached = seconds, cached


def build_cuda(src_name: str, defines: tuple = ()) -> Built:
    """Compile ``csrc/<src_name>`` with the macros ``defines`` (e.g.
    ``("K2_TIMING",)``), if that build is not there yet, and load it.
    Raises RuntimeError carrying nvcc's output on failure."""
    src = os.path.join(CSRC, src_name)
    with open(src, "rb") as f:
        text = f.read()
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(src_name)[0]
    so = os.path.join(build_dir(), f"lib{stem}_{tag}.so")
    log_path = so + ".log"
    t0 = time.time()
    cached = os.path.exists(so)
    if not cached:
        tmp = so + f".tmp{os.getpid()}"
        cmd = [nvcc_path(), *flags, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src_name} (rc {proc.returncode}):\n{log}"
            )
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, so)
    log = open(log_path).read() if os.path.exists(log_path) else ""
    lib = ctypes.CDLL(so)
    return Built(lib, so, log, time.time() - t0, cached)


class CudaLibrary:
    """``csrc/<source>``, built (with the macros ``defines``) and loaded at
    first use, with its entry points typed. Every entry point returns a ``cudaError_t`` (an int);
    ``call`` raises a RuntimeError on a non-zero one, with the message of
    the library's ``error_fn``. ``on_load(lib)`` runs once, after the
    first load, before the library is used (and raises to refuse it)."""

    def __init__(self, source: str, entries: dict, error_fn: str,
                 on_load=None, defines: tuple = ()):
        self.source, self.entries, self.error_fn = source, entries, error_fn
        self.on_load, self.defines = on_load, tuple(defines)
        self._built = None
        self._fns = {}

    @property
    def built(self) -> Built:
        if self._built is None:
            built = build_cuda(self.source, self.defines)
            for name, argtypes in self.entries.items():
                fn = getattr(built.lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                self._fns[name] = fn
            err = getattr(built.lib, self.error_fn)
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            if self.on_load is not None:
                self.on_load(built.lib)
            self._built = built
        return self._built

    def call(self, entry: str, *args, what: str = "") -> None:
        lib = self.built.lib
        rc = self._fns[entry](*args)
        if rc != 0:
            msg = getattr(lib, self.error_fn)(rc).decode()
            raise RuntimeError(
                f"{what or entry} failed: CUDA error {rc} ({msg})")
