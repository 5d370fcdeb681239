"""The V-cycle apply replayed as a captured CUDA graph.

An apply reads nothing back to the host, and its shapes are fixed once
the program is built, so one apply of a factor tree can be captured as
a `torch.cuda.CUDAGraph` and replayed for every later apply of the same
tree: the card runs the same kernels with the same operands in the same
order, and the host issues one graph launch and two copies in place of
the ~1000 small ops of a three-level apply.

`ApplyGraphs` is the cache a `Preconditioner` owns.  It holds the graphs
of one factorization at a time, one graph per shape, dtype and device
of `b` (a (B, n) block has its own), and knows the factorization by the
identity of its `Factors` value and the `_version` of every tensor the
apply reads: another `Factors`, or an in-place change to one of those
tensors, drops every graph and the next apply captures anew.  The cache
keeps the tensors alive while a graph reads them, so their memory
cannot be reused under it.  A capture
that raises (an op that synchronizes, on a path the benchmark does not
run) leaves its key to the eager apply until the tree changes.

Counters (`utils/timings.py`, always on): every apply through the cache
counts once in `hymls.apply.graph_replays` or `hymls.apply.eager`, every
capture in `hymls.apply.graph_captures`.
"""
from __future__ import annotations

import contextlib
import gc
import warnings
from typing import Callable, NamedTuple

import torch

from ..utils.timings import count


@contextlib.contextmanager
def no_cyclic_gc():
    """No cyclic garbage collection inside the block.  A collection
    inside a capture can free another apply's graph, and destroying a
    graph while a stream captures invalidates the capture (the apply
    then runs eagerly); `torch.cuda.graph` collects before it captures
    for the same reason, which would cost a capture per step far more."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


class CudaGraphs:
    """The capture backend on a CUDA device: a warm-up on a side stream
    (cuBLAS and cuSOLVER handles, workspaces and lazily built kernels
    come into being outside any capture), then a capture on the same
    side stream into one memory pool that every capture of this backend
    shares.  `CUDAGraph.capture_begin` / `capture_end` are called as
    `torch.cuda.graph` calls them, without its device synchronize and
    `empty_cache` on entry: a Newton step's capture then overlaps the
    factorization still running on the card instead of waiting for it
    and returning every cached block to the driver.  The captures are
    replayed one at a time on the caller's stream, so they can share
    the pool's intermediate blocks.  No cyclic garbage collection runs
    during a capture (`no_cyclic_gc`)."""

    def __init__(self):
        self.stream = None
        self.pool = None

    def _side_stream(self, device):
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
        return self.stream

    def warm_up(self, fn, device) -> None:
        """fn() once on the side stream, ordered after the caller's
        stream and before what the caller issues next."""
        side = self._side_stream(device)
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)

    def capture(self, fn, device):
        """(graph, fn's output) with fn's device work captured, not run."""
        side = self._side_stream(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with no_cyclic_gc(), torch.cuda.stream(side):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    graph.capture_end()
        except BaseException:
            # a failed capture can leave allocations on the side stream
            # routed to the pool: use neither again
            self.stream = self.pool = None
            raise
        return graph, out

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


class _Graph(NamedTuple):
    graph: object
    x: torch.Tensor         # the static input the graph reads
    y: torch.Tensor         # the static output it writes


def _tensors(tree, out):
    """The tensors of a tree of dicts, lists and tuples, appended to
    `out`."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


class ApplyGraphs:
    """Captured applies of one factorization (see the module
    docstring).  `backend` is the capture backend, `CudaGraphs` by
    default; tests give a stand-in."""

    def __init__(self, backend=None):
        self.backend = CudaGraphs() if backend is None else backend
        self._tree = None       # (fac, tensors, versions)
        self._graphs = {}       # (shape, dtype, device) -> _Graph | None
        self._retired = []      # dropped graphs, until the next capture
        self._warm = set()      # keys warmed up once in this cache

    def clear(self) -> None:
        """Drop every graph and the factorization they read.  The graphs
        are kept, never to be replayed, until the next capture: the
        memory pool they share with it must not fall empty in between,
        or torch would have to free it and build it anew
        (`CudaGraphs`)."""
        self._retired += [g.graph for g in self._graphs.values() if g]
        self._tree = None
        self._graphs = {}

    def _holds(self, fac) -> bool:
        """Whether the graphs read this factorization, none of its
        tensors changed in place since."""
        t = self._tree
        return t is not None and t[0] is fac and \
            all(x._version == v for x, v in zip(t[1], t[2]))

    def __call__(self, body: Callable, fac, b):
        """body(fac, b), the apply of the `Factors` value `fac`, replayed
        from its graph for b's shape, dtype and device, captured on the
        first call; a fresh tensor, never the graph's static output."""
        if not self._holds(fac):
            self.clear()
            ts = _tensors((fac.tree, fac.plans), [])
            self._tree = (fac, ts, [x._version for x in ts])
        key = (tuple(b.shape), b.dtype, b.device)
        g = self._graphs.get(key, False)
        if g is False:
            g = self._graphs[key] = self._capture(body, fac, b, key)
        if g is None:
            count("hymls.apply.eager")
            return body(fac, b)
        g.x.copy_(b)
        self.backend.replay(g.graph)
        count("hymls.apply.graph_replays")
        return g.y.clone()

    def _capture(self, body, fac, b, key):
        x = b.clone(memory_format=torch.contiguous_format)
        if key not in self._warm:
            self.backend.warm_up(lambda: body(fac, x), b.device)
            self._warm.add(key)
        try:
            graph, y = self.backend.capture(lambda: body(fac, x), b.device)
        except Exception as e:
            self._warm.clear()          # the backend's side stream is new
            warnings.warn(f"the apply of a {tuple(b.shape)} {b.dtype} "
                          f"vector could not be captured as a CUDA graph "
                          f"and runs eagerly: {e}", RuntimeWarning)
            return None
        self._retired = []
        count("hymls.apply.graph_captures")
        return _Graph(graph, x, y)
