"""The V-cycle apply's graph cache (hymls_tpu_torch/core/apply_graph.py).

On the CPU `Preconditioner.apply_fn` runs the apply op by op and counts
it in `hymls.apply.eager`; no graph code runs.  The cache's keying and
invalidation are held here with a stand-in for the CUDA capture backend:
a "graph" is the captured function, and a replay runs it again into the
static output, as a CUDA graph writes its static output in place."""
import gc
import weakref
from collections import defaultdict

import numpy as np
import pytest
import torch

from hymls_tpu_torch import Params, Preconditioner
from hymls_tpu_torch.core.apply_graph import ApplyGraphs
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.utils import timings

from portbench.harness import reader
from portbench.tests.helpers import ROOT


def stokes_params(structured="Auto", bgrid=False):
    return Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": 16, "ny": 16},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Separator Length": 4, "Number of Levels": 2,
                           "Structured Apply": structured,
                           "B-Grid Transform": bgrid}})


APPLIES = {"structured": {}, "generic": {"structured": False}}


class FakeGraph:
    def __init__(self, fn, y):
        self.fn, self.y = fn, y


class FakeGraphs:
    """A capture backend on the CPU: capture runs the function once for
    its output, replay runs it again and writes the static output in
    place.  `fail` makes every capture raise, as an op that synchronizes
    makes a CUDA capture raise."""

    def __init__(self, fail=False):
        self.fail = fail
        self.warmups = self.captures = self.replays = 0
        self.graphs = []            # weak references to every capture

    def warm_up(self, fn, device):
        self.warmups += 1
        fn()

    def capture(self, fn, device):
        self.captures += 1
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        g = FakeGraph(fn, fn())
        self.graphs.append(weakref.ref(g))
        return g, g.y

    def replay(self, g):
        self.replays += 1
        g.y.copy_(g.fn())


def build(structured="Auto", bgrid=False):
    p = stokes_params(structured, bgrid)
    K = create_matrix(p).tocsr()
    P = Preconditioner(K, p, testvector=create_testvector(p, K),
                       dtype=torch.float32, device="cpu")
    P.compute()
    return P, K


@pytest.fixture(scope="module", params=sorted(APPLIES))
def built(request):
    torch.set_num_threads(1)
    P, K = build(**APPLIES[request.param])
    assert (P._structured is not None) == (request.param == "structured")
    return P, K


@pytest.fixture
def counters(monkeypatch):
    c = defaultdict(int)
    monkeypatch.setattr(timings, "_COUNTERS", c)
    return c


def vectors(n, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, n, dtype=torch.float32, generator=g)


def with_fake(P, monkeypatch, fail=False):
    """P's cache with the stand-in backend; returns (cache, backend)."""
    fake = FakeGraphs(fail)
    graphs = ApplyGraphs(fake)
    monkeypatch.setattr(P, "_graphs", graphs)
    return graphs, fake


def through(P, graphs, b):
    """One apply through the cache, as apply_fn makes it on a card."""
    return graphs(P._apply_body, P.apply_factors, P._aplans, b)


def eager(P, b):
    return P._apply_eager(P.apply_factors, P._aplans, b)


def test_cpu_apply_is_eager_and_counted(built, counters, monkeypatch):
    P, K = built

    def refuse(*a, **k):
        raise AssertionError("graph code ran on the CPU")

    monkeypatch.setattr(ApplyGraphs, "__call__", refuse)
    b = vectors(K.shape[0])
    x = P.apply_fn(P.apply_factors, P._aplans, b)
    B = P.apply_fn(P.apply_factors, P._aplans, vectors(K.shape[0], 3))
    assert x.shape == b.shape and B.shape == (3, K.shape[0])
    assert dict(counters) == {"hymls.apply.eager": 2}
    assert torch.equal(x, P.apply_inverse(b))
    assert P._graphs._tree is None and not P._graphs._graphs


def test_same_tree_captures_once_then_replays(built, counters,
                                              monkeypatch):
    P, K = built
    graphs, fake = with_fake(P, monkeypatch)
    bs = vectors(K.shape[0], 4)
    xs = [through(P, graphs, b) for b in bs]
    assert (fake.warmups, fake.captures, fake.replays) == (1, 1, 4)
    assert counters["hymls.apply.graph_captures"] == 1
    assert counters["hymls.apply.graph_replays"] == 4
    assert "hymls.apply.eager" not in counters
    for x, b in zip(xs, bs):
        assert torch.equal(x, eager(P, b))


def test_results_are_fresh_tensors(built, counters, monkeypatch):
    """Two successive results are both still valid: neither is the
    static output that the next replay overwrites."""
    P, K = built
    graphs, _ = with_fake(P, monkeypatch)
    b1, b2 = vectors(K.shape[0], 2, seed=3)
    x1 = through(P, graphs, b1)
    x2 = through(P, graphs, b2)
    through(P, graphs, -b2)
    (g,) = graphs._graphs.values()
    for x, b in ((x1, b1), (x2, b2)):
        assert torch.equal(x, eager(P, b))
        assert x.data_ptr() != g.y.data_ptr()
        assert x.data_ptr() != g.x.data_ptr()
    # the static input was copied, not kept: b1 is not written
    assert torch.equal(b1, vectors(K.shape[0], 2, seed=3)[0])


def test_block_has_its_own_entry(built, counters, monkeypatch):
    P, K = built
    graphs, fake = with_fake(P, monkeypatch)
    n = K.shape[0]
    b, B = vectors(n), vectors(n, 3, seed=1)
    for _ in range(2):
        x, X = through(P, graphs, b), through(P, graphs, B)
    assert fake.captures == 2 and fake.replays == 4
    assert {k[0] for k in graphs._graphs} == {(n,), (3, n)}
    assert torch.equal(x, eager(P, b)) and torch.equal(X, eager(P, B))
    # another dtype is another entry too
    through(P, graphs, b.double())
    assert fake.captures == 3


def test_compute_drops_the_graph_and_recaptures():
    """compute(K2) drops the old graph and the tree it read; the next
    apply captures on K2, equals the eager apply on K2 and releases the
    old graph, which until then kept the memory pool from falling
    empty."""
    torch.set_num_threads(1)
    P, K = build()
    fake = FakeGraphs()
    P._graphs = graphs = ApplyGraphs(fake)
    b = vectors(K.shape[0], seed=5)
    x1 = through(P, graphs, b)
    old_tree = weakref.ref(P.apply_factors["levels"][0]["A11"])
    assert fake.captures == 1
    K2 = K.copy()
    K2.data = K2.data * (1.0 + 0.25 * np.random.default_rng(2).random(
        K2.nnz))
    P.compute(K2)
    assert graphs._tree is None and not graphs._graphs
    x2 = through(P, graphs, b)
    assert fake.captures == 2 and fake.warmups == 1
    gc.collect()
    assert fake.graphs[0]() is None and old_tree() is None
    assert graphs._retired == []
    assert torch.equal(x2, eager(P, b)) and not torch.equal(x1, x2)


def test_set_border_drops_the_graphs(counters, monkeypatch):
    P, K = build()
    graphs, fake = with_fake(P, monkeypatch)
    through(P, graphs, vectors(K.shape[0]))
    P.set_border(np.ones(K.shape[0]))
    assert graphs._tree is None and not graphs._graphs


def test_in_place_change_to_a_factor_recaptures(built, counters,
                                                monkeypatch):
    P, K = built
    graphs, fake = with_fake(P, monkeypatch)
    b = vectors(K.shape[0], seed=7)
    x0 = through(P, graphs, b)
    leaf = P.apply_factors["coarse"]
    leaf = leaf["inv"] if "inv" in leaf else leaf["lu"]
    try:
        leaf.mul_(2.0)                  # bumps the tensor's _version
        x1 = through(P, graphs, b)
        assert fake.captures == 2
        assert torch.equal(x1, eager(P, b)) and not torch.equal(x0, x1)
        through(P, graphs, b)
        assert fake.captures == 2 and fake.replays == 3
    finally:
        leaf.mul_(0.5)


def test_failed_capture_runs_eagerly_once_per_key(built, counters,
                                                  monkeypatch):
    P, K = built
    graphs, fake = with_fake(P, monkeypatch, fail=True)
    n = K.shape[0]
    b = vectors(n, seed=9)
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        x = through(P, graphs, b)
    through(P, graphs, b)
    through(P, graphs, b)
    assert fake.captures == 1 and fake.replays == 0
    assert counters["hymls.apply.eager"] == 3
    assert "hymls.apply.graph_captures" not in counters
    assert torch.equal(x, eager(P, b))
    # another key is tried once of its own
    with pytest.warns(RuntimeWarning):
        through(P, graphs, vectors(n, 2))
    assert fake.captures == 2


def test_bgrid_apply_through_the_cache(counters, monkeypatch):
    """The B-grid conjugation is inside what is captured."""
    P, K = build(bgrid=True)
    assert P._bgrid is not None
    graphs, fake = with_fake(P, monkeypatch)
    b = vectors(K.shape[0], seed=11)
    xs = [through(P, graphs, b) for _ in range(2)]
    assert fake.captures == 1 and fake.replays == 2
    assert torch.equal(xs[1], eager(P, b))


def test_apply_graph_share_reads_the_program_counters(monkeypatch):
    read = reader(ROOT + "/portbench", "apply_graph_share.resolve")
    monkeypatch.setattr(timings, "_COUNTERS", defaultdict(int))
    assert read(None) is None
    timings.count("hymls.apply.eager", 1)
    assert read(None) == 0.0
    timings.count("hymls.apply.graph_replays", 199)
    timings.count("hymls.apply.graph_captures", 3)
    assert read(None) == 0.995
    # a program without counters reads nothing, and does not raise
    monkeypatch.delattr(timings, "counter_snapshot")
    assert read(None) is None
