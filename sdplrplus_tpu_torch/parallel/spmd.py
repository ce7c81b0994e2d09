"""Meshes and placement for the sharded solve.

Counterpart of the JAX package's ``parallel/spmd.py``. torch has no
GSPMD, so the port has one SPMD form, the explicit collectives of
``parallel/shardmap.py``: ``shard_problem`` returns the same rank-local
problem as ``shardmap_problem(..., halo=False)``, where the JAX package
placed the problem for XLA to insert the collectives. One process runs
one rank; the world is the torch.distributed process group.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from ..compile import CompiledProblem
from ..ops.device import DeviceProblem
from .comm import Mesh
from .shardmap import shardmap_problem


def _rank_device(backend: str, rank: int, device) -> torch.device:
    """This rank's torch device: the caller's, else one card per rank
    under NCCL (LOCAL_RANK, else the rank modulo the cards) and the CPU
    under gloo."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(torch.cuda.device_count(), 1)))
        return torch.device("cuda", local)
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
              device=None) -> Mesh:
    """The 1-D mesh over the ranks of the initialized process group
    (``parallel.multihost.initialize``, torchrun, or a spawned worker);
    ``n_devices``, when given, must be its world size. Without a process
    group, a one-rank group of this process is initialized (a
    ``file://`` rendezvous in a temporary directory), so ``make_mesh(1,
    backend="nccl")`` runs the sharded program at world size 1; more
    ranks need one process each. ``backend`` is the group's (for a new
    group: NCCL on the card, gloo on the CPU); ``device`` defaults to one
    card per rank under NCCL, the CPU under gloo."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs one process per rank: "
                "initialize the process group first "
                "(parallel.multihost.initialize, or torchrun), or pass "
                f"devices={n_devices} to sdplr, which starts the workers")
        if backend is None:
            want = torch.device(device) if device is not None else None
            backend = "nccl" if (want is None or want.type == "cuda") \
                and torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(_rank_device("nccl", 0, device))
        path = os.path.join(tempfile.mkdtemp(prefix="sdplr_rdv_"), "rdv")
        dist.init_process_group(backend, init_method=f"file://{path}",
                                world_size=1, rank=0)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"the process group has {size} rank(s), the mesh "
                         f"asks for {n_devices}")
    group_backend = str(dist.get_backend()).lower()
    if backend is not None and backend != group_backend:
        raise ValueError(f"the process group runs {group_backend}, the mesh "
                         f"asks for {backend}")
    backend = group_backend
    dev = _rank_device(backend, rank, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs card tensors, got device {dev}")
    return Mesh(group=None, rank=rank, size=size, device=dev,
                backend=backend)


def shard_problem(cp: CompiledProblem, dtype, mesh: Mesh) -> DeviceProblem:
    """This rank's problem with the all-gathered SpMM row support (the
    JAX package's GSPMD placement, here the explicit form)."""
    return shardmap_problem(cp, dtype, mesh, halo=False)


def shard_factor(R: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's row block of a full (n_pad, r) factor, on its device."""
    n = R.shape[0] // mesh.size
    return R[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x on this rank's device (every rank holds the whole array)."""
    return x.to(mesh.device)
