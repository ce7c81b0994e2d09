"""Multi-process bring-up: torch.distributed initialization and the
global mesh for running the sharded solve across processes and hosts.

Counterpart of the JAX package's ``parallel/multihost.py`` (there
jax.distributed). One process per rank: ``initialize`` wires this
process into the group (a coordinator ``host:port``, the world size and
this rank, or the ``env://`` variables torchrun sets), after which every
rank calls ``sdplr(..., devices=world_size)`` with the same problem; the
solve builds ``global_mesh()`` and each rank compiles the same problem
(deterministically) and keeps its rows. Nothing here reads a cluster
from the environment beyond what the caller or torchrun passes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .comm import Mesh
from .spmd import make_mesh

_DEVICE: Optional[str] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Optional[str] = None) -> None:
    """Join the process group: ``coordinator_address`` ``host:port``
    (a TCP rendezvous), the world size and this process's rank; with no
    address, torchrun's ``env://`` variables. ``backend`` defaults to
    NCCL when ``device`` is a card (the default when one is present) and
    gloo otherwise; ``device`` is what ``global_mesh`` places the rank's
    tensors on ("cuda", one card per rank under NCCL, or "cpu")."""
    global _DEVICE
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(backend, **kw)
    _DEVICE = device


def global_mesh() -> Mesh:
    """The 1-D mesh over every rank of the group, rank order (each rank's
    row block contiguous)."""
    return make_mesh(device=_DEVICE)


def is_coordinator() -> bool:
    """Whether this process writes what the ranks share (rank 0, or no
    process group)."""
    return (not dist.is_initialized()) or dist.get_rank() == 0


def process_info() -> dict:
    """Group summary (for logs and result JSON)."""
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "backend": str(dist.get_backend()) if up else None,
        "local_device_count": (torch.cuda.device_count()
                               if torch.cuda.is_available() else 0),
    }
