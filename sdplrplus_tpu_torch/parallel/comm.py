"""The collectives of the sharded solve, over torch.distributed.

Counterpart of the JAX package's collectives inside ``shard_map``
(``lax.psum``, ``lax.all_gather(tiled=True)``, ``lax.ppermute`` and
``lax.axis_index``). A ``Mesh`` names the process group, this process's
rank, the world size, the torch device of the rank's tensors and the
backend; a rank-local ``DeviceProblem`` carries it as its ``spmd`` field
(None on one device, where every hook below is the identity).

  * ``psum``            all_reduce(SUM) of a copy (the input is kept);
  * ``all_gather_rows`` the row blocks of every rank, concatenated in rank
                        order (all_gather_into_tensor);
  * ``ring_shift``      send to rank + t, receive from rank − t
                        (batch_isend_irecv), the halo exchange's step;
  * ``broadcast_obj``   a picklable value from rank 0 (the solver's
                        result, the host polish);
  * ``clock``           rank 0's time.time() (host decisions on time).

``CALLS`` counts the calls of each, for the phase that reads the
collectives' cost (chip_smoke.py phase 18).

gloo has no CUDA all_gather nor CUDA send/recv: on a gloo mesh whose
tensors live on the card every collective copies its input to the host,
runs there and copies the result back, explicitly (``Mesh.staged``). An
NCCL mesh never stages.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist


CALLS = collections.Counter()   # collective calls by name


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of ``size`` ranks, one process each."""
    group: Any            # torch.distributed process group (None: WORLD)
    rank: int
    size: int
    device: torch.device  # where this rank's tensors live
    backend: str          # "nccl" or "gloo"

    @property
    def staged(self) -> bool:
        """Collectives go through host memory (gloo with card tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _to_comm(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A contiguous copy of x where the backend can read it."""
    if mesh.staged:
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone().contiguous()


def _from_comm(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x if x.device == like.device else x.to(like.device)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ over ranks of x (every rank gets the same tensor). Booleans sum
    as int64 counts."""
    CALLS["psum"] += 1
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    buf = _to_comm(x.reshape(-1) if x.dim() == 0 else x, mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return _from_comm(buf, x).reshape(x.shape)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(n_loc, ...) row block of every rank -> (size·n_loc, ...), rank
    order (the JAX package's ``all_gather(..., tiled=True)``)."""
    CALLS["all_gather_rows"] += 1
    buf = _to_comm(x, mesh)
    out = torch.empty((mesh.size * buf.shape[0],) + tuple(buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    dist.all_gather_into_tensor(out, buf, group=mesh.group)
    return _from_comm(out, x)


def ring_shift(x: torch.Tensor, shift: int, mesh: Mesh) -> torch.Tensor:
    """Send x to rank + shift and return what rank − shift sent (the JAX
    package's ``ppermute`` with perm [(s, (s + shift) % nd)])."""
    CALLS["ring_shift"] += 1
    buf = _to_comm(x, mesh)
    recv = torch.empty_like(buf)
    dst = (mesh.rank + shift) % mesh.size
    src = (mesh.rank - shift) % mesh.size
    grp = mesh.group
    peer = (lambda r: r) if grp is None else (
        lambda r: dist.get_global_rank(grp, r))
    ops = [dist.P2POp(dist.isend, buf, peer(dst), grp),
           dist.P2POp(dist.irecv, recv, peer(src), grp)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _from_comm(recv, x)


def broadcast_obj(obj, mesh: Mesh):
    """Rank 0's ``obj`` on every rank (pickled through the group)."""
    CALLS["broadcast_obj"] += 1
    box = [obj if mesh.rank == 0 else None]
    dev = mesh.device if mesh.backend == "nccl" else None
    dist.broadcast_object_list(box, src=_global(mesh, 0), group=mesh.group,
                               device=dev)
    return box[0]


def _global(mesh: Mesh, r: int) -> int:
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def clock(mesh: Mesh | None) -> float:
    """time.time(), rank 0's on every rank of a mesh, so decisions on
    elapsed time (time limits, adaptive step budgets) agree."""
    if mesh is None:
        return time.time()
    CALLS["clock"] += 1
    dev = "cpu" if mesh.backend == "gloo" else mesh.device
    t = torch.tensor([time.time()], dtype=torch.float64, device=dev)
    dist.broadcast(t, src=_global(mesh, 0), group=mesh.group)
    return float(t)


# ---- the hooks of a rank-local DeviceProblem (identity on one device) -------

def mesh_of(dp) -> Mesh | None:
    return getattr(dp, "spmd", None)


def dp_psum(x: torch.Tensor, dp) -> torch.Tensor:
    mesh = mesh_of(dp)
    return x if mesh is None else psum(x, mesh)


def dp_full(dp, X: torch.Tensor) -> torch.Tensor:
    """The full (n_pad, ...) array from this rank's row block."""
    mesh = mesh_of(dp)
    return X if mesh is None else all_gather_rows(X, mesh)


def n_loc(dp) -> int:
    """Rows of the factor this rank holds: n_pad on one device."""
    mesh = mesh_of(dp)
    return dp.n_pad if mesh is None else dp.n_pad // mesh.size


def row_offset(dp) -> int:
    """Global index of this rank's first row (the JAX package's
    ``axis_index · n_loc``)."""
    mesh = mesh_of(dp)
    return 0 if mesh is None else mesh.rank * (dp.n_pad // mesh.size)


def local_rows(dp, X: torch.Tensor) -> torch.Tensor:
    """This rank's row block of a full (n_pad, ...) array."""
    off = row_offset(dp)
    return X[off:off + n_loc(dp)]
