"""SDPLRPlus in PyTorch and CUDA: the low-rank SDP solver of the JAX
package ``sdplrplus_tpu`` ported to an NVIDIA H100.

Burer-Monteiro factorization + augmented Lagrangian + L-BFGS + exact
quartic (equality) or Armijo (inequality) line search + Lanczos
suboptimality bound + dynamic rank doubling, with the inner loop as one
hand-written CUDA kernel: K1 for equality problems and K2 for the
inequality families (ops/megakernel.py, csrc/megakernel.cu,
csrc/megakernel_armijo.cu). The entry points (``sdplr``, ``solve``,
``solve_model`` for an external model of ``adapter.py``) run on the card
unless the caller passes ``device="cpu"``; ``devices=N`` row-shards a
solve over N torch.distributed ranks (``parallel/``). This package
imports neither JAX nor ``sdplrplus_tpu``.
"""

from .config import SolverConfig
from .problem import SDPProblem, SparseSym, SymLowRank, make_problem, sparse_coo
from .compile import compile_problem
from .solver.outer import sdplr, solve, solve_model
from .solver.rank import barvinok_pataki
from .convert import (
    device_problem_from_numpy,
    inner_carry_from_numpy,
    major_carry_from_numpy,
)

__all__ = [
    "SolverConfig",
    "SDPProblem",
    "SparseSym",
    "SymLowRank",
    "make_problem",
    "sparse_coo",
    "compile_problem",
    "sdplr",
    "solve",
    "solve_model",
    "barvinok_pataki",
    "device_problem_from_numpy",
    "inner_carry_from_numpy",
    "major_carry_from_numpy",
]
