"""The port's persistent compile cache: its nvcc build directory.

The JAX package keeps XLA's persistent compilation cache, so a re-run of
the same (program, shapes) pair skips the compiler. The port compiles
nothing but its CUDA sources (``csrc/``) and the host compiler core, with
nvcc and g++, at first use; each library is kept in the build directory
of ``utils/build.py`` under a hash of its source and flags, so a re-run
loads it without building. That directory is the port's whole compile
cache. It uses no ``torch.compile``: the torch code runs eagerly and the
hot loops are the hand-written kernels, so there is no other compiled
program to keep.

Called by every driver (``exps/run.py``, ``exps/sweep.py``, ``bench.py``
of this package). Library imports change nothing.
"""

from __future__ import annotations

import os

from .build import BUILD_ENV, build_dir


def enable_compile_cache(path: str | None = None) -> str:
    """Point the nvcc build directory at ``path`` (default: the one in use,
    ``SDPLRPLUS_TORCH_BUILD`` or ``sdplrplus_tpu_torch/_build``).

    Idempotent; returns the directory in use. Libraries already loaded
    stay loaded; builds after the call go to ``path``."""
    if path is not None:
        os.environ[BUILD_ENV] = os.path.abspath(path)
    return build_dir()
