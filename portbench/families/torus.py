"""Two-dimensional toroidal grids with ±1 weights, as rudy draws them
for Gset's grid graphs (``-toroidal_grid_2D h w -random 0 1 <seed>
-times 2 -plus -1``): h·w vertices numbered row by row, each joined to
its right and its lower neighbour with wrap-around (2·h·w edges), each
edge weighing +1 or −1 with probability ½. At h = 100, w = 200 this is
the shape of G81 (20,000 vertices, 40,000 edges); the seed draws the
signs."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def graph(params: dict, seed: int) -> sp.csr_matrix:
    h, w = int(params["h"]), int(params["w"])
    v = np.arange(h * w).reshape(h, w)
    i = np.concatenate([v.ravel(), v.ravel()])
    j = np.concatenate([np.roll(v, -1, axis=1).ravel(),
                        np.roll(v, -1, axis=0).ravel()])
    wt = 2.0 * np.random.default_rng(seed).integers(0, 2, i.shape[0]) - 1.0
    A = sp.coo_matrix((np.concatenate([wt, wt]),
                       (np.concatenate([i, j]), np.concatenate([j, i]))),
                      shape=(h * w, h * w))
    return A.tocsr()
