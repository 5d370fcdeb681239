"""One factorization value behind the preconditioner
(`core/preconditioner.py:Factors`, made by `Preconditioner.factorize`)
and the one refinement loop of `solvers/mixed.py`.

A Newton step is the factorization of its values followed by the
refinement solve: it must give, bit for bit, what `compute` (or the
warm `recompute`) followed by `solve` gives on the same values, on the
structured and on the generic apply.  It factors through `factorize`
like every other path, so it counts one `hymls.compute.calls` and drops
the graphs of the previous factorization at once."""
import numpy as np
import pytest
import torch

from hymls_tpu_torch import Params
from hymls_tpu_torch.core.apply_graph import ApplyGraphs
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.utils import timings

from test_torch_apply_graph import FakeGraphs

APPLIES = {"structured": "Auto", "generic": False}


def _params(structured):
    """Stokes-C 16^2, two skew levels, the f64-refined solve to 1e-10."""
    return Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2,
                    "nx": 16, "ny": 16},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Iterative Solver": {"Maximum Iterations": 200,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Partitioner": "Skew Cartesian",
                           "Separator Length": 4, "Number of Levels": 2,
                           "Structured Apply": structured}})


def _solver(structured, K):
    p = _params(structured)
    S = IterativeRefinementSolver(K, p, testvector=create_testvector(
        _params(structured), K), device="cpu")
    assert (S.precond._structured is not None) == (structured == "Auto")
    return S


def _problem():
    K = create_matrix(_params(False)).tocsr()
    K.sort_indices()
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    K2 = K.copy()
    K2.data = K.data * (1.0 + 1e-3 * np.cos(np.arange(K.nnz)))
    return K, K2, b


def _same(r, S):
    """A Newton step's result against S's last solve: equal x, equal
    inner iterations, both converged."""
    assert r.converged and S._last_result.converged
    assert r.iters == S.num_iter
    assert torch.equal(r.x, S._last_result.x)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("apply", sorted(APPLIES))
def test_newton_steps_equal_compute_then_solve(apply):
    """`newton_step` equals `compute(K2)` then `solve`, and
    `newton_step_warm` from the factors of K equals `recompute(K2)` then
    `solve`: the same x, bit for bit, and the same iterations."""
    K, K2, b = _problem()
    S = _solver(APPLIES[apply], K).compute(K)
    ref = _solver(APPLIES[apply], K).compute(K)
    assert S.precond.factors.structured == (apply == "structured")
    fac0 = S.precond.factors

    S.solver.set_matrix(K2)
    S.op64.set_values(K2.data)
    cold = S.newton_step(S.op64.vals, S.solver.op.vals, b)
    ref.compute(K2)
    ref.solve(b)
    _same(cold, ref)

    warm, fac1 = S.newton_step_warm(S.op64.vals, S.solver.op.vals, b, fac0)
    assert fac1.structured == fac0.structured and fac1 is not fac0
    ref.compute(K)
    ref.precond.recompute(K2)
    ref.solver.set_matrix(K2)
    ref.op64.set_values(K2.data)
    ref.solve(b)
    _same(warm, ref)
    # the step's own factorization, not the preconditioner's current one
    assert S.precond.factors is fac0


def test_newton_step_factors_once_and_drops_the_graphs(monkeypatch):
    """A Newton step counts one `hymls.compute.calls`, and the graph
    captured on the previous factorization is dropped when it factors:
    the cache holds nothing until an apply of the new value captures."""
    K, K2, b = _problem()
    S = _solver("Auto", K).compute(K)
    P = S.precond
    fake = FakeGraphs()
    monkeypatch.setattr(P, "_graphs", ApplyGraphs(fake))
    v = torch.ones(K.shape[0], dtype=torch.float32)
    P._graphs(P._apply_body, P.factors, v)
    assert P._graphs._graphs and fake.captures == 1
    S.solver.set_matrix(K2)
    S.op64.set_values(K2.data)
    before = timings.counter_snapshot()
    factorize = P.factorize
    made = []
    monkeypatch.setattr(P, "factorize",
                        lambda *a, **k: made.append(factorize(*a, **k))
                        or made[-1])
    S.newton_step(S.op64.vals, S.solver.op.vals, b)
    after = timings.counter_snapshot()
    assert after["hymls.compute.calls"] - \
        before.get("hymls.compute.calls", 0) == 1
    assert len(made) == 1
    assert P._graphs._tree is None and not P._graphs._graphs
    assert len(P._graphs._retired) == 1
    P._graphs(P._apply_body, made[0], v)
    assert fake.captures == 2 and P._graphs._retired == []
    assert P._graphs._tree[0] is made[0]
