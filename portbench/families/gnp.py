"""Random graphs with exactly M = round(d·n(n−1)/200) edges, the pairs
drawn uniformly without replacement, unit weights: rudy's
``-rnd_graph n d`` (d the density in percent), with which Gset's random
graphs were drawn. At n = 800, d = 6 that is G1's generator and G1's
19,176 edges."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def edges(n: int, density_pct: float) -> int:
    return int(round(density_pct * n * (n - 1) / 200.0))


def graph(params: dict, seed: int) -> sp.csr_matrix:
    n = int(params["n"])
    m = edges(n, float(params["density_pct"]))
    rng = np.random.default_rng(seed)
    i, j = np.triu_indices(n, 1)
    pick = rng.choice(i.shape[0], m, replace=False)
    i, j = i[pick], j[pick]
    A = sp.coo_matrix((np.ones(2 * m),
                       (np.concatenate([i, j]), np.concatenate([j, i]))),
                      shape=(n, n))
    return A.tocsr()
