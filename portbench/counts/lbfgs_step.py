"""Least work of one inner L-BFGS step of SDPLR+ on a problem whose
constraints are all diagonal (MaxCut: Xᵢᵢ = 1), at n rows (the padded
rows the step runs over), factor rank r, k L-BFGS pairs and itemsize w.

One step: the gradient's and the exact line search's products with C,
the two-loop direction over the k pairs, the quartic's coefficients, the
update of R, G and the ring. Besides the product with C it takes
(8k + 29)·n·r + 18·n operations: two dot products and two axpys over
n·r per pair and the step's elementwise passes.

* ``fastdiag_step``: C sparse with nnz stored entries, one sparse
  product per step (2·nnz·r). Bytes: C's values and column ids read
  once; R, G, C·R and the 2k ring vectors read once; R, G, C·R and the
  new pair written once; the diagonal's multipliers read once.
* ``k1_iteration``: C dense, n × n (2·n²·r per iteration), kept on chip
  for all the iterations of one launch; ``k1_launch_bytes`` is what a
  launch reads and writes once: C, R in and out, the ring in and out,
  and the n-vectors (b, λ, the violation).
"""

from __future__ import annotations


def _elementwise_flops(n: int, r: int, k: int) -> float:
    return (8.0 * k + 29.0) * n * r + 18.0 * n


def fastdiag_step(n: int, nnz: int, r: int, k: int, itemsize: int = 4):
    """(operations, bytes) of one step with sparse C."""
    flops = 2.0 * nnz * r + _elementwise_flops(n, r, k)
    nbytes = (nnz * (itemsize + 4)
              + itemsize * n * r * (3 + 2 * k + 3 + 2)
              + itemsize * n)
    return flops, nbytes


def k1_iteration_flops(n: int, r: int, k: int) -> float:
    """Operations of one iteration with dense C."""
    return 2.0 * n * n * r + _elementwise_flops(n, r, k)


def k1_launch_bytes(n: int, r: int, k: int, itemsize: int = 4) -> float:
    """Bytes one launch of the dense inner loop reads and writes once."""
    return itemsize * (n * n + 2 * n * r + 2 * 2 * k * n * r + 4 * n)
