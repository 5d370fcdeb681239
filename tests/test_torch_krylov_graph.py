"""GMRES's iterations replayed from captured CUDA graphs
(hymls_tpu_torch/solvers/krylov.py: `_arnoldi`, `GmresGraphs`).

On the CPU GMRES runs the eager loop and counts `hymls.gmres.eager`; no
graph code runs.  The workspaces, their captures and replays are held
here with a stand-in for the CUDA capture backend: a capture records the
function without running it, a replay runs it, as a CUDA graph does.
The graph path must give the eager loop's iterates bit for bit."""
import gc
import warnings
import weakref
from collections import defaultdict

import numpy as np
import pytest
import torch

from hymls_tpu_torch import Params
from hymls_tpu_torch.solvers import krylov
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.utils import timings

N, M, RESTART = 48, 40, 7


class FakeGraph:
    def __init__(self, fn):
        self.fn = fn


class FakeGraphs:
    """A capture backend on the CPU: warm_up runs the function, capture
    keeps it without running it, replay runs it.  `fail` makes every
    capture raise, as an op that synchronizes makes a CUDA capture
    raise.  One instance serves every workspace of a cache (`made`
    counts the workspaces)."""

    def __init__(self, fail=False):
        self.fail = fail
        self.made = self.warmups = self.captures = self.replays = 0
        self.graphs = []            # weak references to every capture

    def __call__(self):
        self.made += 1
        return self

    def warm_up(self, fn, device):
        self.warmups += 1
        fn()

    def capture(self, fn, device):
        self.captures += 1
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        g = FakeGraph(fn)
        self.graphs.append(weakref.ref(g))
        return g, None

    def replay(self, g):
        self.replays += 1
        g.fn()


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def counters(monkeypatch):
    c = defaultdict(int)
    monkeypatch.setattr(timings, "_COUNTERS", c)
    return c


def graphed(monkeypatch, fail=False):
    """The process's GMRES workspaces replaced by a cache of the stand-in
    backend that takes CPU tensors; returns (cache, backend)."""
    fake = FakeGraphs(fail)
    cache = krylov.GmresGraphs(fake, device_type="cpu")
    monkeypatch.setattr(krylov, "_GRAPHS", cache)
    return cache, fake


def system(dtype, seed=0, n=N):
    """A nonsymmetric system, a rough preconditioner and two right-hand
    sides, in `dtype`."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        x = torch.randn(*shape, 2 if dtype.is_complex else 1,
                        dtype=torch.float64, generator=g)
        return torch.view_as_complex(x) if dtype.is_complex else x[..., 0]

    d = torch.linspace(1.0, 5.0, n, dtype=torch.float64)
    A = (torch.diag(d) + 0.6 * rnd(n, n) / n ** 0.5).to(dtype)
    Minv = torch.diag(1.0 / d).to(dtype)
    return ((lambda v: A @ v), (lambda v: Minv @ v), rnd(n).to(dtype),
            rnd(n).to(dtype))


def solve(op, prec, b, **kw):
    kw = {"tol": 1e-10, "maxiter": M, **kw}
    return krylov.gmres(op, b, torch.zeros_like(b), prec, **kw)


def same(r, ref):
    assert torch.equal(r.x, ref.x)
    assert (r.iters, r.relres, r.converged) == \
        (ref.iters, ref.relres, ref.converged)


DTYPES = {"f64": torch.float64, "f32": torch.float32,
          "c128": torch.complex128}


@pytest.mark.parametrize("restart", [None, RESTART], ids=["full", "restart"])
@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_graph_path_equals_the_eager_loop(dtype, left, restart,
                                          monkeypatch, counters):
    """The captured and the replayed iterations give the eager loop's x,
    iterations and residual bit for bit, on two right-hand sides (the
    second solve replays on the first's stale workspace)."""
    op, prec, b1, b2 = system(DTYPES[dtype])
    tol = 1e-5 if dtype == "f32" else 1e-10
    kw = dict(left=left, restart=restart, tol=tol)
    eager = [solve(op, prec, b, **kw) for b in (b1, b2)]
    assert all(r.converged and r.iters > 2 for r in eager)
    if restart:
        assert eager[0].iters > restart
    assert counters["hymls.gmres.eager"] == sum(r.iters for r in eager)
    counters.clear()
    cache, fake = graphed(monkeypatch)
    for r, ref in zip([solve(op, prec, b, **kw) for b in (b1, b2)], eager):
        same(r, ref)
    replays = counters["hymls.gmres.graph_replays"]
    assert replays == fake.replays > 0
    assert counters["hymls.gmres.eager"] + replays == \
        sum(r.iters for r in eager)
    assert fake.made == 1 and len(cache._spaces) == 1


def test_each_k_is_captured_once_then_replayed(monkeypatch, counters):
    op, prec, b1, b2 = system(torch.float64, seed=1)
    cache, fake = graphed(monkeypatch)
    r1 = solve(op, prec, b1)
    (ws,) = cache._spaces.values()
    assert sorted(ws.graphs) == list(range(r1.iters))
    assert fake.warmups == fake.captures == r1.iters and fake.replays == 0
    assert dict(counters) == {"hymls.gmres.eager": r1.iters,
                              "hymls.gmres.graph_captures": r1.iters,
                              "hymls.gmres.iters": r1.iters,
                              "hymls.gmres.capped": 0}
    r2 = solve(op, prec, b2)
    # only the iterations the first solve did not reach are captured
    new = max(r2.iters - r1.iters, 0)
    assert fake.replays == r2.iters - new
    assert counters["hymls.gmres.graph_captures"] == r1.iters + new
    assert counters["hymls.gmres.graph_replays"] == r2.iters - new
    assert counters["hymls.gmres.eager"] == r1.iters + new
    assert len(ws.graphs) == max(r1.iters, r2.iters)
    # another dtype or basis size is another workspace
    solve(op, prec, b1, maxiter=M + 1)
    solve(lambda v: (op(v.double())).float(), lambda v: prec(v.double())
          .float(), b1.float(), tol=1e-5)
    assert fake.made == 3 and len(cache._spaces) == 3


def _stokes_params():
    return Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": 8, "ny": 8},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Iterative Solver": {"Maximum Iterations": 200,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Separator Length": 4,
                           "Number of Levels": 1}})


def test_a_newton_step_captures_nothing_new(monkeypatch, counters):
    """Refinement solves on a second factorization (`compute(K2)`, a new
    `Factors` value) replay the first one's graphs: the graphs read no
    operator and no factor, and the solves equal the eager ones."""
    p = _stokes_params()
    K = create_matrix(p).tocsr()
    K2 = K.copy()
    K2.data = K.data * (1.0 + 1e-3 * np.cos(np.arange(K.nnz)))
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])

    def steps():
        S = IterativeRefinementSolver(K, p, testvector=create_testvector(
            p, K), device="cpu").compute(K)
        out = [(S.solve(b), S.num_iter)]
        fac = S.precond.factors
        S.compute(K2)
        assert S.precond.factors is not fac
        out.append((S.solve(b), S.num_iter))
        return out

    eager = steps()
    counters.clear()
    cache, fake = graphed(monkeypatch)
    S = IterativeRefinementSolver(K, p, testvector=create_testvector(p, K),
                                  device="cpu").compute(K)
    x1 = S.solve(b)
    captured = counters["hymls.gmres.graph_captures"]
    (ws,) = cache._spaces.values()
    assert captured == len(ws.graphs) > 0
    S.compute(K2)
    x2 = S.solve(b)
    assert torch.equal(x1, eager[0][0]) and torch.equal(x2, eager[1][0])
    # every pass of the second step starts at k = 0; the only captures
    # are of iterations the first step never reached
    assert counters["hymls.gmres.graph_captures"] == len(ws.graphs)
    assert len(ws.graphs) <= max(captured, eager[1][1])
    assert counters["hymls.gmres.graph_replays"] >= \
        eager[1][1] - (len(ws.graphs) - captured)


@pytest.mark.parametrize("restart", [None, RESTART], ids=["full", "restart"])
def test_nested_solve_with_the_same_key_runs_eagerly(restart, monkeypatch,
                                                     counters):
    """A solve inside the preconditioner with the same (n, m, dtype,
    device) does not write into the outer solve's workspace: it runs
    eagerly, and the outer solve still equals the all-eager one."""
    op, prec, b, _ = system(torch.float64, seed=2)

    def inner(v):
        return solve(op, prec, v, tol=1e-3, restart=restart).x

    eager = solve(op, inner, b, restart=restart)
    counters.clear()
    cache, fake = graphed(monkeypatch)
    r = solve(op, inner, b, restart=restart)
    same(r, eager)
    assert fake.made == 1
    assert counters["hymls.gmres.graph_captures"] + \
        counters["hymls.gmres.graph_replays"] == r.iters
    assert counters["hymls.gmres.eager"] > r.iters   # the inner solves
    (ws,) = cache._spaces.values()
    assert not ws.busy


def test_cpu_tensors_and_allreduce_stay_eager(monkeypatch, counters):
    op, prec, b, _ = system(torch.float64, seed=4)

    def refuse():
        raise AssertionError("a workspace was made")

    # the process's cache takes CUDA tensors only
    assert krylov._GRAPHS.device_type == "cuda"
    monkeypatch.setattr(krylov, "_GRAPHS", krylov.GmresGraphs(refuse))
    ref = solve(op, prec, b)
    assert dict(counters) == {"hymls.gmres.eager": ref.iters,
                              "hymls.gmres.iters": ref.iters,
                              "hymls.gmres.capped": 0}
    # a sum over one rank: the owner-sharded loop, eager on any device
    counters.clear()
    cache, fake = graphed(monkeypatch)
    r = solve(op, prec, b, allreduce=lambda t: t)
    assert r.converged and fake.made == 0 and not cache._spaces
    assert dict(counters) == {"hymls.gmres.eager": r.iters,
                              "hymls.gmres.iters": r.iters,
                              "hymls.gmres.capped": 0}


def test_a_failed_capture_leaves_its_key_to_the_eager_loop(monkeypatch,
                                                           counters):
    op, prec, b1, b2 = system(torch.float64, seed=5)
    eager = [solve(op, prec, b) for b in (b1, b2)]
    counters.clear()
    cache, fake = graphed(monkeypatch, fail=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rs = [solve(op, prec, b) for b in (b1, b2)]
        assert sum("could not be captured" in str(m.message)
                   for m in w) == 1
        # another key tries a capture of its own
        solve(op, prec, b1, maxiter=M + 1)
    for r, ref in zip(rs, eager):
        same(r, ref)
    assert fake.captures == 2 and fake.replays == 0
    assert "hymls.gmres.graph_captures" not in counters


def test_the_least_recently_used_workspace_is_dropped(monkeypatch):
    op, prec, b, _ = system(torch.float64, seed=6)
    cache, fake = graphed(monkeypatch)
    monkeypatch.setattr(cache, "keep", 2)
    solve(op, prec, b, maxiter=M)
    first = list(fake.graphs)
    solve(op, prec, b, maxiter=M + 1)
    solve(op, prec, b, maxiter=M)           # M is now the most recent
    solve(op, prec, b, maxiter=M + 2)       # drops M + 1
    assert [k[1] for k in cache._spaces] == [M, M + 2]
    assert all(g() is not None for g in first)
    solve(op, prec, b, maxiter=M + 3)       # drops M and its graphs
    assert [k[1] for k in cache._spaces] == [M + 2, M + 3]
    # a stand-in graph keeps its function, whose closure holds the
    # workspace: a cycle, which a CUDA graph does not make
    gc.collect()
    assert all(g() is None for g in first)
