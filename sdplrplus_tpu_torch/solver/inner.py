"""The torch inner L-BFGS loop, run on the device in chunks of K steps.

Counterpart of the JAX package's ``solver/inner.py`` (reference:
src/sdplr.jl:190-278): direction, descent-direction fallback, line
search (exact quartic, or Armijo with every candidate step at once), the
step, the gradient, norms, the fprec stagnation test and the ring
update. This is the engine ``inner_impl="xla"`` names (the name is kept
from the JAX package); the CUDA megakernels (ops/megakernel.py) compute
the same loop in one launch.

The JAX package runs a chunk of inner steps as one ``lax.while_loop`` on
the device and syncs the host once per chunk. Here a step reads nothing
on the host: the exit test is a device flag, the ring head a 0-dim
device tensor, and a step whose exit test fails (``masked_step``) leaves
the carry exactly as it was, by selection. ``CHUNK_K`` such steps make
one chunk program, after which the host reads one small status tensor
(continue, steps, ring head, stagnated) and stops once the flag is down.
An activation of s steps thus costs ⌈s/K⌉ chunks and host reads (one
when it is empty) and at most K − 1 masked steps at its end. K is
``CHUNK_K`` on the card and ``CPU_CHUNK_K`` (1) on CPU tensors.

On the card the chunk program is captured once per (problem, rank,
dtype, engine, k, line search) as a CUDA graph (``_InnerGraph``) and
replayed, one host read per replay; it runs the same operations in the
same order as the eager program. The eager program runs instead, by
rule (ROADMAP, "Differences by design"): on CPU tensors (in chunks of
one step), on a gloo mesh (its collectives are staged through host
memory, which a graph cannot hold) and for an external model
(``adapter.CustomModel``: Python callables). A failed capture or replay
raises; nothing falls back.

``use_cx`` selects the fast-diagonal engine (C sparse, every constraint
entry diagonal): one SpMM CD = C@D per iteration feeds both line-search
products, and the gradient comes from the carried recurrence
CX ← CX + α·CD, refreshed exactly at major boundaries (solver/major.py).

A step is taken while grad_norm > cur_gtol, the last step did not
stagnate (rel ΔL < stag_tol, reference: src/sdplr.jl:236-241), the step
budget lasts and the state is healthy (L finite, σ finite and below
2¹⁰⁰, where solver/major.py stops). The L-BFGS update is skipped on the
stagnation exit.

On a rank-local problem (``dp.spmd``) R, G, CX and the L-BFGS history
are this rank's rows, and the dots over rows are summed across ranks
(the JAX package's inner.py under shard_map); every rank then takes the
same branches.

Launch counters count Python calls of the kernels' wrappers, which a
replay does not make: capture leaves the counters as they were, and
each replay adds the launches and calls the captured program made
(``gather.KERNELS``, ``spmm.CALLS``, ``comm.CALLS``). ``STATS`` counts
the loop's own work: steps taken, chunks run, host reads, masked steps,
replays, captures and the warm-up steps that precede a capture.

Every capture, here and in solver/inner_entry.py, goes through
``capture_graph``: into one memory pool per (device, graph kind), kept
for the process, with no device synchronization and no emptied cache,
so a solve's capture reuses the memory of the solve before.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Any

import torch

from ..ops import gather as _gather
from ..ops import spmm as _spmm
from ..ops.adjoint import gradient, gradient_cx
from ..ops.device import DeviceProblem, fast_diag_eligible
from ..ops.forward import A_linesearch_cd
from ..ops.spmm import spmm_C
from ..parallel import comm as _comm
from ..parallel.comm import dp_psum
from ..utils.timing import span
from .al import capped_vio
from .lbfgs import LBFGSState, lbfgs_direction, lbfgs_push
from .linesearch import (
    armijo_from_products, armijo_linesearch, exact_from_products,
    exact_linesearch,
)

# steps per chunk program, i.e. per host read, on the card (K = 4, 8 and
# 16 measured on SYN20K by chip_smoke.py phase 11, PERF.md §6), and on
# CPU tensors, where a read costs nothing and a masked step costs a
# step: there the chunk is one step, so no step is masked
CHUNK_K = 8
CPU_CHUNK_K = 1
WARMUP_STEPS = 2       # single steps run eagerly before a capture
SIGMA_CAP = 2.0 ** 100  # σ at or above it is a failed state

# "steps" taken, "chunks" run, host "reads", "masked" steps (run in a
# chunk, not taken), graph "replays", "captures", "warmup_steps";
# "pooled_captures" (graphs captured into a kept pool, ``capture_graph``)
# and "capture_frees" (the allocator's device frees inside
# ``sdplr.inner.capture`` spans); and, counted by solver/major.py, the
# state machine's "branch_reads" (one per body: an activation or a
# boundary)
STATS = collections.Counter()


@dataclasses.dataclass
class InnerCarry:
    R: torch.Tensor
    G: torch.Tensor
    y_full: torch.Tensor
    vio_raw: torch.Tensor
    L_val: torch.Tensor      # 0-dim
    grad_norm: torch.Tensor  # 0-dim
    lbfgs: LBFGSState
    steps: Any               # steps taken this chunk (an int; a 0-dim
    #                          int64 tensor inside the chunk program)
    stagnated: Any           # bool (a 0-dim bool tensor inside)
    CX: Any = None           # fast-diagonal engine only: C_sparse @ R


def _step(dp: DeviceProblem, c: InnerCarry, lam, sigma, stag_tol, go, *,
          k: int, use_armijo: bool, gtol_relative: bool,
          lbfgs_compact: bool, use_cx: bool) -> InnerCarry:
    """One inner iteration from ``c`` (reference: src/sdplr.jl:196-246)
    with no host read. ``go`` None takes it; a 0-dim bool tensor takes
    it where true and returns ``c``'s values where false, by selection."""
    gscale = dp.normC if gtol_relative else 1.0

    # direction + descent fallback (reference: src/sdplr.jl:196-205)
    mesh = dp.spmd
    direction = lbfgs_direction(c.lbfgs, c.G, k, compact=lbfgs_compact,
                                mesh=mesh)
    descent = dp_psum(torch.sum(direction * c.G), dp)
    bad = torch.isnan(descent) | (descent >= 0.0)
    direction = torch.where(bad, -c.G, direction)

    # line search (reference: src/sdplr.jl:210-215), then the step and
    # the gradient (reference: src/sdplr.jl:219-223)
    if use_cx:
        CD = spmm_C(dp, direction)
        A_RD, A_DD = A_linesearch_cd(dp, c.R, direction, CD)
        if use_armijo:
            alpha, L_new, vio_new = armijo_from_products(
                dp, A_RD, A_DD, c.vio_raw, lam, sigma, c.y_full)
        else:
            alpha, L_new, vio_new = exact_from_products(
                dp, A_RD, A_DD, c.vio_raw, lam, sigma)
        R_new = c.R + alpha * direction
        CX_new = c.CX + alpha * CD
        G_new, y_new = gradient_cx(dp, R_new, CX_new, lam, sigma, vio_new)
    else:
        CX_new = c.CX
        if use_armijo:
            alpha, L_new, vio_new = armijo_linesearch(
                dp, c.R, direction, c.vio_raw, lam, sigma, c.y_full)
        else:
            alpha, L_new, vio_new = exact_linesearch(
                dp, c.R, direction, c.vio_raw, lam, sigma)
        R_new = c.R + alpha * direction
        G_new, y_new = gradient(dp, R_new, lam, sigma, vio_new)
    gnorm = torch.sqrt(dp_psum(torch.sum(G_new * G_new), dp)) / gscale

    # fprec stagnation (reference: src/sdplr.jl:236-241)
    one = torch.ones((), dtype=L_new.dtype, device=L_new.device)
    rel_delta = (c.L_val - L_new) / torch.maximum(
        one, torch.maximum(L_new.abs(), c.L_val.abs()))
    stagnated = rel_delta < stag_tol

    # L-BFGS update, skipped (by selection) on the stagnation exit
    new_lbfgs = c.lbfgs
    if k > 0:
        push = ~stagnated if go is None else go & ~stagnated
        new_lbfgs = lbfgs_push(c.lbfgs, alpha, direction, c.G, G_new, k,
                               mesh=mesh, push=push)

    if go is None:
        return InnerCarry(R=R_new, G=G_new, y_full=y_new, vio_raw=vio_new,
                          L_val=L_new, grad_norm=gnorm, lbfgs=new_lbfgs,
                          steps=c.steps + 1, stagnated=stagnated, CX=CX_new)
    sel = lambda new, old: torch.where(go, new, old)
    return InnerCarry(
        R=sel(R_new, c.R), G=sel(G_new, c.G), y_full=sel(y_new, c.y_full),
        vio_raw=sel(vio_new, c.vio_raw), L_val=sel(L_new, c.L_val),
        grad_norm=sel(gnorm, c.grad_norm), lbfgs=new_lbfgs,
        steps=c.steps + go.to(c.steps.dtype),
        stagnated=sel(stagnated, c.stagnated),
        CX=None if CX_new is None else sel(CX_new, c.CX))


def inner_step(dp: DeviceProblem, c: InnerCarry, lam, sigma, stag_tol, *,
               k: int, use_armijo: bool, gtol_relative: bool,
               lbfgs_compact: bool = True, use_cx: bool = False) -> InnerCarry:
    """One inner L-BFGS iteration (reference: src/sdplr.jl:196-246),
    taken unconditionally; ``stagnated`` and the ring head come back as
    device tensors."""
    return _step(dp, c, lam, sigma, stag_tol, None, k=k,
                 use_armijo=use_armijo, gtol_relative=gtol_relative,
                 lbfgs_compact=lbfgs_compact, use_cx=use_cx)


def _continues(c: InnerCarry, sigma, cur_gtol, max_steps):
    """The exit test before a step, as a 0-dim bool device tensor."""
    return ((c.grad_norm > cur_gtol) & ~c.stagnated & (c.steps < max_steps)
            & torch.isfinite(c.L_val) & torch.isfinite(sigma)
            & (sigma < SIGMA_CAP))


def masked_step(dp: DeviceProblem, c: InnerCarry, lam, sigma, stag_tol,
                cur_gtol, max_steps, **kw) -> InnerCarry:
    """One step of the chunk program on a device-form carry (0-dim
    ``steps``, ``stagnated`` and ring head): taken where the exit test
    passes, else ``c`` unchanged, by selection."""
    go = _continues(c, sigma, cur_gtol, max_steps)
    return _step(dp, c, lam, sigma, stag_tol, go, **kw)


def chunk_program(dp: DeviceProblem, c: InnerCarry, lam, sigma, stag_tol,
                  cur_gtol, max_steps, n_steps: int, **kw):
    """``n_steps`` masked steps, then the status the host reads: (carry,
    int64 [continue, steps, ring head, stagnated])."""
    for _ in range(n_steps):
        c = masked_step(dp, c, lam, sigma, stag_tol, cur_gtol, max_steps,
                        **kw)
    status = torch.stack([
        _continues(c, sigma, cur_gtol, max_steps).to(torch.int64),
        c.steps.to(torch.int64), c.lbfgs.head.to(torch.int64),
        c.stagnated.to(torch.int64)])
    return c, status


# ---- the device-form carry --------------------------------------------------

_TENSORS = ("R", "G", "y_full", "vio_raw", "L_val", "grad_norm", "steps",
            "stagnated")
_RING = ("s_hist", "y_hist", "rho", "head", "sty", "yty")


def _scalar(x, dtype, device) -> torch.Tensor:
    """``x`` as a 0-dim tensor on ``device``: a Python number by a fill,
    not a copy from host memory."""
    if torch.is_tensor(x):
        return x.to(dtype=dtype, device=device).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def _device_form(ic: InnerCarry) -> InnerCarry:
    """``ic`` with 0-dim device tensors for its steps (from 0), its
    stagnation flag (False) and its ring head."""
    dev, dtype = ic.R.device, ic.R.dtype
    return dataclasses.replace(
        ic, L_val=_scalar(ic.L_val, dtype, dev),
        grad_norm=_scalar(ic.grad_norm, dtype, dev),
        steps=torch.zeros((), dtype=torch.int64, device=dev),
        stagnated=torch.zeros((), dtype=torch.bool, device=dev),
        lbfgs=dataclasses.replace(
            ic.lbfgs, head=_scalar(ic.lbfgs.head, torch.int64, dev)))


def _copy_carry(dst: InnerCarry, src: InnerCarry):
    """In-place copy of every tensor of ``src`` into ``dst``'s buffers."""
    for f in _TENSORS:
        getattr(dst, f).copy_(getattr(src, f))
    if dst.CX is not None:
        dst.CX.copy_(src.CX)
    for f in _RING:
        getattr(dst.lbfgs, f).copy_(getattr(src.lbfgs, f))


def _clone_carry(c: InnerCarry) -> InnerCarry:
    return dataclasses.replace(
        c, CX=None if c.CX is None else c.CX.clone(),
        lbfgs=LBFGSState(**{f: getattr(c.lbfgs, f).clone() for f in _RING}),
        **{f: getattr(c, f).clone() for f in _TENSORS})


# ---- launch counters under replay -------------------------------------------

def _read_counts() -> dict:
    """Every counter a captured chunk program moves, by name."""
    out = {("gather", kk.name): kk.launches for kk in _gather.KERNELS}
    out.update({("spmm", n): v for n, v in _spmm.CALLS.items()})
    out.update({("comm", n): v for n, v in _comm.CALLS.items()})
    return out


def _add_counts(delta: dict, times: int):
    kernels = {kk.name: kk for kk in _gather.KERNELS}
    for (where, name), v in delta.items():
        if where == "gather":
            kernels[name].launches += v * times
        elif where == "spmm":
            _spmm.CALLS[name] += v * times
        else:
            _comm.CALLS[name] += v * times


def launches_of(program) -> dict:
    """Run ``program()`` and return what it added to every counter
    (nonzero entries), leaving the counters as they were: what one
    replay of the program captured there launches."""
    before = _read_counts()
    program()
    after = _read_counts()
    delta = {key: v - before.get(key, 0) for key, v in after.items()
             if v != before.get(key, 0)}
    _add_counts(delta, -1)
    return delta


# ---- runners: the chunk program eagerly, or as a CUDA graph ----------------

class _EagerChunks:
    """The chunk program run eagerly, one host read per chunk."""

    def __init__(self, dp, K: int, kw: dict):
        self.dp, self.K, self.kw = dp, K, kw

    def run(self, c, lam, sigma, stag_tol, cur_gtol, max_steps):
        chunks = 0
        while True:
            c, status = chunk_program(self.dp, c, lam, sigma, stag_tol,
                                      cur_gtol, max_steps, self.K, **self.kw)
            chunks += 1
            cont, steps, head, stag = status.tolist()   # the host read
            if not cont:
                return c, (steps, head, stag), chunks


# ---- graph capture into a memory pool kept for the process ----------------

class _GraphPool:
    """The memory of one kind of graph on one device, kept for the
    process: a pool id (``torch.cuda.graph_pool_handle``); a keeper, a
    one-node graph captured into the pool when it is made and never
    replayed, which holds the pool's use count above zero in the device
    and the pinned-host caching allocators (a pool whose last graph is
    released is otherwise marked freeable: an emptied cache then returns
    its memory to the driver, and a capture into it before that fails the
    allocator's check); the side stream on which every warm-up and
    capture of that kind runs (the allocator reuses a block on the stream
    that freed it); and a weak reference to the runner whose graph holds
    the pool."""

    def __init__(self, device: torch.device):
        self.id = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device=device)
        self.owner = None
        # thread_local: an NCCL watchdog thread may run meanwhile
        self.keeper = self.capture(lambda: torch.zeros((), device=device),
                                   "thread_local")

    def on_stream(self, work):
        """``work()`` on the side stream, after the current stream's work
        so far and before its work from now on."""
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = work()
        current.wait_stream(self.stream)
        return out

    def capture(self, program, mode: str):
        graph = torch.cuda.CUDAGraph()

        def work():
            graph.capture_begin(pool=self.id, capture_error_mode=mode)
            try:
                program()
            finally:
                graph.capture_end()

        self.on_stream(work)
        return graph


_POOLS: dict = {}   # (device, kind) → _GraphPool


def graph_pool(device, kind: str) -> _GraphPool:
    """The kept pool of graphs of ``kind`` ("inner", "entry") on
    ``device``, made at its first use."""
    key = (torch.device(device), kind)
    if key not in _POOLS:
        _POOLS[key] = _GraphPool(key[0])
    return _POOLS[key]


def capture_graph(owner, program, device, kind: str,
                  mode: str = "global"):
    """Capture ``program()`` as a CUDA graph into the kept pool of
    ``kind`` on ``device`` and return it; ``owner`` is the runner that
    keeps the graph in its ``graph`` attribute.

    The capture runs on the pool's side stream, which first waits on the
    current stream, and the current stream waits on it afterwards. Unlike
    ``torch.cuda.graph(...)``, this synchronizes nothing, collects no
    garbage and empties no cache: the allocator keeps its cached blocks,
    and each capture of a kind takes the memory of the one before. ``mode``
    is the capture's ``capture_error_mode``.

    One live graph per pool: before the capture begins, the graph that
    held the pool is released (reset, and dropped by its runner, which
    captures again if it is run again). So two graphs of one pool are
    never replayed in turn. That matters because the second capture lays
    its intermediates, and any tensor it keeps, over the memory that the
    first graph's replays write: a replay of the first would overwrite
    them."""
    pool = graph_pool(device, kind)
    old = pool.owner() if pool.owner is not None else None
    if old is not None and old.graph is not None:
        old.graph.reset()
        old.graph = None
    pool.owner = None
    graph = pool.capture(program, mode)
    pool.owner = weakref.ref(owner)
    STATS["pooled_captures"] += 1
    return graph


def _device_frees(device) -> int:
    """The allocator's device frees so far (``num_device_free``) on a
    CUDA device; 0 elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("num_device_free", 0)


@contextlib.contextmanager
def capture_span(device):
    """The ``sdplr.inner.capture`` span (warm-up steps and the capture),
    adding the allocator's device frees inside it to
    ``STATS["capture_frees"]``."""
    frees = _device_frees(device)
    with span("sdplr.inner.capture"):
        yield
    STATS["capture_frees"] += _device_frees(device) - frees


class _InnerGraph:
    """The chunk program captured as a CUDA graph on static buffers: the
    carry and the major iteration's inputs (λ, σ, stag_tol, cur_gtol,
    the step budget) are loaded by copy before a run; each replay
    advances the carry K masked steps in place and writes the status."""

    def __init__(self, key, dp, c: InnerCarry, lam, sigma, stag_tol,
                 cur_gtol, max_steps, *, K: int, kw: dict):
        self.key, self.dp, self.K, self.kw = key, dp, K, kw
        self.c = _clone_carry(c)
        self.ins = [x.clone() for x in (lam, sigma, stag_tol, cur_gtol,
                                        max_steps)]
        self.status = torch.zeros(4, dtype=torch.int64, device=c.R.device)
        self.graph = None
        with capture_span(c.R.device):
            self._warm_up()
            self.per_replay = launches_of(self._capture)
        STATS["captures"] += 1

    def _warm_up(self):
        """Single steps on the pool's side stream: the gather library's
        build, library handles, workspaces and the cached index tensors
        are made outside the capture (real launches: they stay
        counted)."""
        def steps():
            for _ in range(WARMUP_STEPS):
                self._program(1)

        graph_pool(self.c.R.device, "inner").on_stream(steps)
        STATS["warmup_steps"] += WARMUP_STEPS

    def _capture(self):
        """Capture the K-step program into the kept pool. A collective on
        an NCCL mesh is issued with its own stream and watchdog thread,
        so there only this thread's calls are held to the capture's
        rules."""
        mode = "global" if self.dp.spmd is None else "thread_local"
        self.graph = capture_graph(self, lambda: self._program(self.K),
                                   self.c.R.device, "inner", mode)

    def _program(self, n_steps: int):
        c, status = chunk_program(self.dp, self.c, *self.ins, n_steps,
                                  **self.kw)
        _copy_carry(self.c, c)
        self.status.copy_(status)

    def run(self, c, lam, sigma, stag_tol, cur_gtol, max_steps):
        _copy_carry(self.c, c)
        for dst, src in zip(self.ins, (lam, sigma, stag_tol, cur_gtol,
                                       max_steps)):
            dst.copy_(src)
        replays = 0
        while True:
            self.graph.replay()
            _add_counts(self.per_replay, 1)
            replays += 1
            cont, steps, head, stag = self.status.tolist()   # the host read
            if not cont:
                break
        STATS["replays"] += replays
        return _clone_carry(self.c), (steps, head, stag), replays


class InnerGraphs:
    """The captured chunk program of one solve: at most one graph, for
    the problem, rank and engine in use; another replaces it, the old
    graph released first. A graph that a later capture released (one
    live graph per pool, ``capture_graph``) is captured again."""

    def __init__(self):
        self._g = None

    def get(self, key, dp, make) -> _InnerGraph:
        g = self._g
        if g is None or g.key != key or g.dp is not dp or g.graph is None:
            self._g = None
            self._g = make()
        return self._g


def _external(dp) -> bool:
    return any(getattr(dp, f, None) is not None
               for f in ("fn_A_uu", "fn_A_uv", "fn_apply_S"))


def captures(dp, R: torch.Tensor) -> bool:
    """Whether the chunk program runs as a CUDA graph: CUDA tensors, one
    device or an NCCL mesh, and no external model."""
    return (R.is_cuda and not _external(dp)
            and (dp.spmd is None or dp.spmd.backend == "nccl"))


def chunk_steps(device) -> int:
    """K, the steps of one chunk, for tensors on ``device``."""
    return CHUNK_K if torch.device(device).type == "cuda" else CPU_CHUNK_K


def run_activation(dp: DeviceProblem, ic: InnerCarry, lam, sigma, cur_gtol,
                   stag_tol, max_steps, *, k: int, use_armijo: bool,
                   gtol_relative: bool, lbfgs_compact: bool = True,
                   use_cx: bool = False, graph: bool | None = None,
                   graphs: InnerGraphs | None = None) -> InnerCarry:
    """Up to ``max_steps`` inner steps from ``ic`` (its stagnation flag
    is cleared), in chunks of K steps with one host read each: as a
    CUDA graph where ``graph`` (default: ``captures``), kept in
    ``graphs`` across calls (else captured for this call), else eagerly.
    Returns the carry with ``steps`` = ic.steps + the steps taken, an
    int ring head and a bool ``stagnated``."""
    dtype, dev = ic.R.dtype, ic.R.device
    t = lambda x: _scalar(x, dtype, dev)
    ins = (lam, t(sigma), t(stag_tol), t(cur_gtol),
           _scalar(int(max_steps), torch.int64, dev))
    c = _device_form(ic)
    K = chunk_steps(ic.R.device)
    kw = dict(k=k, use_armijo=use_armijo, gtol_relative=gtol_relative,
              lbfgs_compact=lbfgs_compact, use_cx=use_cx)
    if graph is None:
        graph = captures(dp, ic.R)
    if graph:
        key = (id(dp), tuple(ic.R.shape), dtype, dev, K,
               tuple(sorted(kw.items())))
        runner = (graphs or InnerGraphs()).get(
            key, dp, lambda: _InnerGraph(key, dp, c, *ins, K=K, kw=kw))
    else:
        runner = _EagerChunks(dp, K, kw)
    c, (steps, head, stag), chunks = runner.run(c, *ins)
    STATS["steps"] += steps
    STATS["chunks"] += chunks
    STATS["reads"] += chunks
    STATS["masked"] += K * chunks - steps
    return dataclasses.replace(
        c, lbfgs=dataclasses.replace(c.lbfgs, head=head),
        steps=ic.steps + steps, stagnated=bool(stag))


def inner_chunk(dp: DeviceProblem, R, G, y_full, vio_raw, L_val, grad_norm,
                lbfgs: LBFGSState, lam, sigma, cur_gtol, stag_tol,
                max_steps, *, k: int, use_armijo: bool, gtol_relative: bool,
                ptol_relative: bool, lbfgs_compact: bool = True,
                graph: bool | None = None,
                graphs: InnerGraphs | None = None):
    """Run up to ``max_steps`` inner iterations (``run_activation``).
    Returns (carry, vio_norm)."""
    pscale = dp.normb if ptol_relative else 1.0
    use_cx = fast_diag_eligible(dp)
    ic = InnerCarry(R=R, G=G, y_full=y_full, vio_raw=vio_raw, L_val=L_val,
                    grad_norm=grad_norm, lbfgs=lbfgs, steps=0,
                    stagnated=False, CX=spmm_C(dp, R) if use_cx else None)
    c = run_activation(dp, ic, lam, sigma, cur_gtol, stag_tol, max_steps,
                       k=k, use_armijo=use_armijo,
                       gtol_relative=gtol_relative,
                       lbfgs_compact=lbfgs_compact, use_cx=use_cx,
                       graph=graph, graphs=graphs)
    vio_norm = torch.linalg.norm(capped_vio(dp, c.vio_raw)) / pscale
    return c, vio_norm
