"""The capture of the inner loop's CUDA graphs into a memory pool kept for
the process (solver/inner.py ``capture_graph``), on the CPU: the CUDA
pieces it calls (``torch.cuda.CUDAGraph``, the pool handle, the streams)
are stand-ins that log each call, and the calls that empty the
allocator's cache, synchronize the device or collect garbage raise."""

import gc
import pathlib
import re

import pytest
import torch

from sdplrplus_tpu_torch.solver import inner

DEV = torch.device("cuda", 0)


class _Owner:
    """A runner: it keeps its graph in ``graph``."""

    def __init__(self):
        self.graph = None


class _Cuda:
    """Stand-ins for the CUDA calls of a capture, logging into ``log``."""

    def __init__(self):
        self.log = []
        self.handles = 0
        self.capturing = None
        cuda = self

        class Graph:
            def capture_begin(self, pool=None, capture_error_mode="global"):
                cuda.log.append(("begin", self, pool, capture_error_mode,
                                 cuda.current))
                cuda.capturing = self

            def capture_end(self):
                cuda.log.append(("end", self))
                cuda.capturing = None

            def reset(self):
                cuda.log.append(("reset", self))

        class Stream:
            def __init__(self, device=None, name="side"):
                self.device, self.name = device, name

            def wait_stream(self, other):
                cuda.log.append(("wait", self.name, other.name))

        class StreamContext:
            def __init__(self, s):
                self.s = s

            def __enter__(self):
                self.prev, cuda.current = cuda.current, self.s.name

            def __exit__(self, *exc):
                cuda.current = self.prev
                return False

        self.Graph, self.Stream = Graph, Stream
        self.current = "current"
        self.main = Stream(DEV, "current")
        self.StreamContext = StreamContext

    def pool_handle(self):
        self.handles += 1
        return (0, self.handles)

    def install(self, monkeypatch):
        def refused(*a, **k):
            raise AssertionError("a capture must not empty a cache, "
                                 "synchronize or collect garbage")

        monkeypatch.setattr(torch.cuda, "CUDAGraph", self.Graph)
        monkeypatch.setattr(torch.cuda, "Stream", self.Stream)
        monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                            self.pool_handle)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: self.main)
        monkeypatch.setattr(torch.cuda, "stream", self.StreamContext)
        monkeypatch.setattr(torch.cuda, "empty_cache", refused)
        monkeypatch.setattr(torch.cuda, "synchronize", refused)
        monkeypatch.setattr(torch._C, "_host_emptyCache", refused,
                            raising=False)
        monkeypatch.setattr(gc, "collect", refused)
        monkeypatch.setattr(torch, "zeros", lambda *a, **k: None)
        monkeypatch.setattr(inner, "_POOLS", {})
        inner.STATS.clear()
        return self


def _capture(cuda, owner, kind="inner", device=DEV, mode="global"):
    """One capture through the helper; returns the graph, after checking
    that the program ran inside it."""
    ran = []

    def program():
        ran.append(cuda.capturing)

    owner.graph = inner.capture_graph(owner, program, device, kind, mode)
    assert ran == [owner.graph]
    return owner.graph


def _begins(cuda):
    return [e for e in cuda.log if e[0] == "begin"]


def test_two_captures_share_one_pool_and_release_the_first(monkeypatch):
    """Two captures on one device: the same pool for both (and for the
    keeper captured when the pool is made), the first graph released
    before the second capture begins, each on the pool's side stream,
    which waits on the current stream before and is waited on after; and
    none of the calls that empty a cache, synchronize or collect."""
    cuda = _Cuda().install(monkeypatch)
    first, second = _Owner(), _Owner()
    g1 = _capture(cuda, first)
    g2 = _capture(cuda, second)
    keeper, b1, b2 = _begins(cuda)
    assert keeper[1] is inner.graph_pool(DEV, "inner").keeper
    assert (b1[1], b2[1]) == (g1, g2)
    assert keeper[2] == b1[2] == b2[2] == (0, 1)
    assert all(b[3] == "global" and b[4] == "side" for b in (b1, b2))
    at = cuda.log.index
    assert at(("reset", g1)) < at(b2)
    assert first.graph is None and second.graph is g2
    assert ("reset", g2) not in cuda.log
    # around each capture: the side stream waits, then is waited on
    i = at(b2)
    assert cuda.log[i - 1] == ("wait", "side", "current")
    assert cuda.log[at(("end", g2)) + 1] == ("wait", "current", "side")
    assert inner.STATS["pooled_captures"] == 2


def test_a_dropped_graph_is_not_reset_and_its_pool_is_reused(monkeypatch):
    """Where the runner that held the pool is gone (a solve's graphs die
    with the solve), the next capture resets nothing and takes the same
    pool; another kind of graph or another device has a pool of its own,
    and the capture mode passes through."""
    cuda = _Cuda().install(monkeypatch)
    owner = _Owner()
    _capture(cuda, owner)
    del owner
    g = _capture(cuda, _Owner(), mode="thread_local")
    assert not [e for e in cuda.log if e[0] == "reset"]
    begins = _begins(cuda)
    assert begins[-1][1] is g and begins[-1][3] == "thread_local"
    assert len({b[2] for b in begins}) == 1
    _capture(cuda, _Owner(), kind="entry")
    _capture(cuda, _Owner(), device=torch.device("cuda", 1))
    pools = [b[2] for b in _begins(cuda)]
    assert len(set(pools)) == 3
    assert set(inner._POOLS) == {(DEV, "inner"), (DEV, "entry"),
                                 (torch.device("cuda", 1), "inner")}


def test_inner_graphs_capture_again_after_a_release():
    """``InnerGraphs.get`` keeps its graph while the key and the problem
    hold, and makes a new one once a later capture released it."""
    made = []

    class Runner:
        def __init__(self, key, dp):
            self.key, self.dp, self.graph = key, dp, object()

    def make():
        made.append(Runner("k", dp))
        return made[-1]

    dp = object()
    graphs = inner.InnerGraphs()
    assert graphs.get("k", dp, make) is graphs.get("k", dp, make)
    assert len(made) == 1
    made[0].graph = None                 # released by another capture
    assert graphs.get("k", dp, make) is made[1]
    assert graphs.get("other", dp, make) is made[2]


def test_capture_span_counts_no_frees_off_the_card():
    """The capture span adds the allocator's device frees inside it to
    ``STATS["capture_frees"]``; off the card there is no allocator to
    read, and it adds 0."""
    inner.STATS.clear()
    with inner.capture_span(torch.device("cpu")):
        pass
    assert inner.STATS["capture_frees"] == 0


@pytest.mark.parametrize("call", [r"empty_cache\(",
                                  r"with\s+torch\.cuda\.graph\("])
def test_the_port_neither_empties_the_cache_nor_enters_cuda_graph(call):
    """No module of the port calls ``torch.cuda.empty_cache`` or enters
    the ``torch.cuda.graph`` context manager, which empties the cache at
    every capture."""
    root = pathlib.Path(inner.__file__).resolve().parents[1]
    hits = [str(p.relative_to(root)) for p in sorted(root.rglob("*.py"))
            if re.search(call, p.read_text())]
    assert not hits
