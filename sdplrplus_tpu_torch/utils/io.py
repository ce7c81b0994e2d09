"""Data ingest: Gset/.mat graph loaders.

A numpy copy of the JAX package's ``utils/io.py``, the equivalent of the
reference's data utilities (reference: exps/data_utils.jl:1-189,
exps/data_preprocess.jl:85-116): MATLAB v7/v7.3 .mat adjacency readers,
Gset text format, and graph cleanup (symmetrize, strip self-loops). A
v7.3 (HDF5) file needs h5py, imported only for such a file.
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import scipy.sparse as sp

# Default data directory of the drivers' --data-root: exps/data inside
# this checkout, laid out as the reference's (<problem>/<name>.mat). The
# Gset files are not in the repository, so it is absent until they are
# put there; pass --data-root to read them from elsewhere.
DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "exps", "data")


def load_mat_adjacency(path: str, key: str = "A") -> sp.csr_matrix:
    """Load a sparse adjacency matrix from a .mat file (v7 or v7.3/HDF5)."""
    try:
        from scipy.io import loadmat

        d = loadmat(path)
        return sp.csr_matrix(d[key])
    except NotImplementedError:
        import h5py

        with h5py.File(path, "r") as f:
            g = f[key]
            data = np.asarray(g["data"])
            ir = np.asarray(g["ir"], dtype=np.int64)
            jc = np.asarray(g["jc"], dtype=np.int64)
            n = jc.shape[0] - 1
            return sp.csc_matrix((data, ir, jc), shape=(n, n)).tocsr()


def _read_text(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def read_gset(path: str) -> sp.csr_matrix:
    """Gset text format: first line "n m", then "i j w" edges (1-based)
    (reference: exps/data_utils.jl read_gset). Parsing runs through the
    native C++ core when available (utils/native.py)."""
    from .native import parse_edges

    text = _read_text(path)
    header_end = text.find(b"\n")
    n = int(text[:header_end].split()[0])
    I, J, W = parse_edges(text[header_end + 1:])
    A = sp.csr_matrix((W, (I - 1, J - 1)), shape=(n, n))
    return postprocess_graph(A)


def read_edge_list(path: str, zero_based: bool = True) -> sp.csr_matrix:
    """Plain (optionally gzipped) edge-list reader for SNAP-style files
    (reference: exps/data_preprocess.jl read_txt_gz). Comment lines
    (#, %) are skipped; parsing is native when available."""
    from .native import parse_edges

    I, J, _ = parse_edges(_read_text(path))
    if not zero_based:
        I, J = I - 1, J - 1
    n = int(max(I.max(initial=0), J.max(initial=0))) + 1
    A = sp.csr_matrix((np.ones(len(I)), (I, J)), shape=(n, n))
    return postprocess_graph(A)


def read_zip_edges(path: str, csv_name: str | None = None) -> sp.csr_matrix:
    """DIMACS10-style zip archive holding ``<name>_edges.csv`` (header row,
    two integer id columns). Ids are shifted to 0-based if needed and the
    graph is symmetrized (reference: exps/data_preprocess.jl read_zip)."""
    import csv
    import io as _io
    import zipfile

    base = os.path.splitext(os.path.basename(path))[0]
    want = csv_name or f"{base}_edges.csv"
    with zipfile.ZipFile(path) as z:
        member = next(
            (nm for nm in z.namelist() if nm.split("/")[-1] == want), None
        )
        if member is None:
            raise FileNotFoundError(f"{want} not found inside {path}")
        with z.open(member) as f:
            reader = csv.reader(_io.TextIOWrapper(f, "utf-8"))
            header = next(reader, None)
            rows_cols = [
                (int(row[0]), int(row[1])) for row in reader if len(row) >= 2
            ]
            # header may itself be an edge (no-header files)
            if header is not None and len(header) >= 2:
                try:
                    rows_cols.insert(0, (int(header[0]), int(header[1])))
                except ValueError:
                    pass
    if not rows_cols:
        return sp.csr_matrix((0, 0))
    I = np.array([e[0] for e in rows_cols], dtype=np.int64)
    J = np.array([e[1] for e in rows_cols], dtype=np.int64)
    shift = int(min(I.min(), J.min()))  # 0- or 1-based ids -> 0-based
    I -= shift
    J -= shift
    n = int(max(I.max(), J.max())) + 1
    A = sp.csr_matrix((np.ones(len(I)), (I, J)), shape=(n, n))
    return postprocess_graph(A)


def postprocess_graph(A: sp.spmatrix, largest_component: bool = False) -> sp.csr_matrix:
    """Symmetrize, binarize sign-free weights' duplicates, strip self-loops;
    optionally restrict to the largest connected component
    (reference: exps/data_preprocess.jl postprocess_graph)."""
    A = sp.csr_matrix(A)
    A = A.maximum(A.T)
    A.setdiag(0)
    A.eliminate_zeros()
    if largest_component:
        ncomp, labels = sp.csgraph.connected_components(A, directed=False)
        if ncomp > 1:
            counts = np.bincount(labels)
            keep = np.flatnonzero(labels == counts.argmax())
            A = A[np.ix_(keep, keep)].tocsr()
    return A


def gset_path(name: str, problem: str = "MaxCut",
              root: str = DATA_ROOT) -> str:
    """``<root>/<problem>/<name>.mat``."""
    return os.path.join(root, problem, f"{name}.mat")


def pad_to_even(A: sp.spmatrix) -> sp.csr_matrix:
    """Append an isolated dummy node when n is odd — needed by the
    minimum-bisection benchmark (reference: exps/data_preprocess.jl
    dummy-node padding)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    if n % 2 == 0:
        return A
    return sp.bmat([[A, sp.csr_matrix((n, 1))],
                    [sp.csr_matrix((1, n)), sp.csr_matrix((1, 1))]]).tocsr()
