"""Graph families, one file each: ``graph(params, seed)`` gives the
symmetric weighted adjacency (SciPy CSR) of one instance, the same for
the same seed. The harness loads a family by the name in a
configuration's file (``families/<name>.py``)."""
