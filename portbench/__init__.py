"""Benchmark of the PyTorch/CUDA port ``sdplrplus_tpu_torch``: Gset-protocol
SDP solves on one H100. ``python -m portbench.run --help``."""
