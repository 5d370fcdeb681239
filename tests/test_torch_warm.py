"""The port's warm recompute against the JAX package's.

  * `warm_inv` (hymls_tpu_torch/core/dense.py) against
    `hymls_tpu.core.dense.warm_inv` on batched blocks, on the accept
    branch (Newton-Schulz polish of the previous inverse) and on the
    fallback branch (a fresh inverse): 1e-12 relative in f64 (both
    reach the f64 residual floor), 1e-5 in f32 (one f32 LU each);
  * `Preconditioner.recompute` on skew Stokes-C 16^2, L = 2 (the setup
    of tests/test_precond.py::test_warm_recompute_matches_fresh): per
    level factors within 1e-10 of the reference's in f64 after a 1e-4
    value jump; after a 0.9 jump every gate fails and the result is
    exactly the cold `compute` of the same matrix;
  * three `newton_step_warm` steps against `newton_step_warm_fn`
    (tests/test_precond.py::test_warm_newton_step_converges's setup):
    true relres <= 1e-10, inner f32 iterations within 2;
  * each gate's branch counted (`hymls.warm.polish` / `.fresh`).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import hymls_tpu as H
from hymls_tpu.core import dense as jdense
from hymls_tpu.solvers.mixed import IterativeRefinementSolver as JIR
import hymls_tpu_torch as T
from hymls_tpu_torch.core import dense as tdense
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver as TIR
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.utils import timings

FACTOR_KEYS = ("A11inv", "G", "A21", "blkinv", "sc")
INV_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-300))


def _blocks(jump, seed=0, s=6, n=10):
    """A batch of well-conditioned blocks A and the exact inverse X0 of
    A with every entry scaled by (1 + jump * N(0, 1))."""
    rng = np.random.default_rng(seed)
    A = 4.0 * np.eye(n) + rng.standard_normal((s, n, n))
    A0 = A * (1.0 + jump * rng.standard_normal(A.shape))
    return A, np.linalg.inv(A0)


def _gate(A, X0):
    return np.abs(np.eye(A.shape[-1]) - A @ X0).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("jump,accepted", [(1e-3, True), (0.9, False)],
                         ids=["accept", "fallback"])
def test_warm_inv_matches_reference(jump, accepted, dtype):
    A, X0 = _blocks(jump)
    assert (_gate(A, X0) < 0.25) == accepted
    ref = np.asarray(jdense.warm_inv(jnp.asarray(A, JDT[dtype]),
                                     jnp.asarray(X0, JDT[dtype])))
    At = torch.as_tensor(A, dtype=dtype)
    got = tdense.warm_inv(At, torch.as_tensor(X0, dtype=dtype))
    assert got.dtype == dtype
    assert _rel(ref, got) <= INV_TOL[dtype]
    fresh = tdense.inv_newton(At)
    if accepted:
        # the polish, not a fresh inverse: a different rounding path
        # that still reaches the dtype's residual floor
        assert not torch.equal(got, fresh)
        eye = torch.eye(A.shape[-1], dtype=dtype)
        assert float((eye - At @ got).abs().max()) <= \
            (1e-12 if dtype == torch.float64 else 1e-5)
    else:
        assert torch.equal(got, fresh)


@pytest.mark.parametrize("jump", [1e-3, 0.9], ids=["accept", "fallback"])
def test_inv_chain_on_the_cpu_branch(jump):
    """The reference's CPU branch of `inv_chain` and `warm_inv_chain`
    is `inv_newton` and `warm_inv(fresh_fn=inv_newton)`."""
    A, X0 = _blocks(jump, seed=1)
    At, Xt = torch.as_tensor(A), torch.as_tensor(X0)
    assert _rel(jdense.inv_chain(jnp.asarray(A)),
                tdense.inv_chain(At)) <= 1e-12
    assert _rel(jdense.warm_inv_chain(jnp.asarray(A), jnp.asarray(X0)),
                tdense.warm_inv_chain(At, Xt)) <= 1e-12


def test_warm_inv_of_an_empty_batch():
    A = torch.zeros((0, 3, 3), dtype=torch.float64)
    assert tdense.warm_inv(A, A).shape == (0, 3, 3)


def _skew_stokes16():
    d = {"Problem": {"Equations": "Stokes-C", "Dimension": 2, "nx": 16,
                     "ny": 16},
         "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                    "Left or Right Preconditioning": "Right",
                    "Iterative Solver": {"Maximum Iterations": 200,
                                         "Convergence Tolerance": 1e-10}},
         "Preconditioner": {"Separator Length": 4, "Number of Levels": 2,
                            "Partitioner": "Skew Cartesian"}}
    K = create_matrix(T.Params(d)).tocsr()
    return d, K, create_testvector(T.Params(d), K)


def _jumped(K, scale, rng):
    K2 = K.copy()
    K2.data = K.data * (1.0 + scale * rng.standard_normal(K.nnz))
    return K2


def test_recompute_matches_reference():
    d, K, tv = _skew_stokes16()
    rng = np.random.default_rng(4)
    K2 = _jumped(K, 1e-4, rng)
    K3 = _jumped(K, 0.9, rng)
    b = np.random.default_rng(3).standard_normal(K.shape[0])

    Pj = H.Preconditioner(K, H.Params(d), testvector=tv).compute()
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv,
                          device="cpu").compute()
    assert Pt._structured_active

    # a modest jump: polished factors, at the reference's to 1e-10
    Pj.recompute(K2)
    Pt.recompute(K2)
    for lev, (fj, ft) in enumerate(zip(Pj._factors["levels"],
                                       Pt.factors.full["levels"])):
        for key in FACTOR_KEYS:
            assert _rel(fj[key], ft[key]) <= 1e-10, (lev, key)
    assert _rel(Pj._factors["coarse"]["inv"],
                Pt.factors.full["coarse"]["inv"]) <= 1e-10
    cold2 = T.Preconditioner(K2, T.Params(d), testvector=tv,
                             device="cpu").compute()
    assert _rel(cold2.factors.full["levels"][0]["A11inv"],
                Pt.factors.full["levels"][0]["A11inv"]) <= 1e-10
    # the structured apply was repacked from the polished factors
    assert _rel(Pj.apply_inverse(b), Pt.apply_inverse(b)) <= 1e-9

    # a large jump: every gate fails, so the warm factors are the cold
    # ones bit for bit, and so is the repack
    Pt.recompute(K3)
    cold3 = T.Preconditioner(K3, T.Params(d), testvector=tv,
                             device="cpu").compute()
    for ft, fc in zip(Pt.factors.full["levels"], cold3.factors.full["levels"]):
        for key in FACTOR_KEYS:
            assert torch.equal(ft[key], fc[key]), key
    assert torch.equal(Pt.factors.full["coarse"]["inv"],
                       cold3.factors.full["coarse"]["inv"])
    assert torch.equal(Pt.apply_inverse(b), cold3.apply_inverse(b))
    Pj.recompute(K3)
    assert _rel(Pj.apply_inverse(b), Pt.apply_inverse(b)) <= 1e-9


def _delta(after, before):
    keys = ("hymls.warm.polish", "hymls.warm.fresh", "hymls.coarse.inverse",
            "hymls.coarse.unknowns")
    return {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def test_recompute_counts_each_gate_branch():
    """Each `warm_inv` counts the branch its gate took: after a modest
    jump some inverses of the recompute are polished, after a large one
    every one is fresh; the warm coarse inverse counts as a coarse
    factor of its order either way."""
    d, K, tv = _skew_stokes16()
    rng = np.random.default_rng(4)
    K2, K3 = _jumped(K, 1e-4, rng), _jumped(K, 0.9, rng)
    P = T.Preconditioner(K, T.Params(d), testvector=tv,
                         device="cpu").compute()
    n = P.factors.full["coarse"]["inv"].shape[-1]
    before = timings.counter_snapshot()
    P.recompute(K2)
    mid = timings.counter_snapshot()
    P.recompute(K3)
    after = timings.counter_snapshot()
    warm, cold = _delta(mid, before), _delta(after, mid)
    calls = warm["hymls.warm.polish"] + warm["hymls.warm.fresh"]
    assert warm["hymls.warm.polish"] >= 1
    assert cold == {"hymls.warm.polish": 0, "hymls.warm.fresh": calls,
                    "hymls.coarse.inverse": 1, "hymls.coarse.unknowns": n}
    assert warm["hymls.coarse.inverse"] == 1
    assert warm["hymls.coarse.unknowns"] == n


def test_recompute_is_cold_without_factors_or_with_a_border():
    d, K, tv = _skew_stokes16()
    P = T.Preconditioner(K, T.Params(d), testvector=tv, device="cpu")
    cold = T.Preconditioner(K, T.Params(d), testvector=tv,
                            device="cpu").compute()
    P.recompute()
    assert torch.equal(P.factors.full["coarse"]["inv"],
                       cold.factors.full["coarse"]["inv"])
    with pytest.raises(ValueError, match="pattern"):
        P.recompute(K[:, :-1].tocsr()[:-1])


def test_newton_step_warm_matches_reference():
    d, K, tv = _skew_stokes16()
    b = K @ np.random.default_rng(5).standard_normal(K.shape[0])

    Sj = JIR(K, H.Params(d), testvector=tv).compute()
    newton, dplans, extra, aplans = Sj.newton_step_warm_fn()
    fac_j = Sj.precond._factors
    St = TIR(K, T.Params(d), testvector=tv, device="cpu").compute()
    fac_t = St.precond.factors
    for i in range(3):
        s = 1.0 + 1e-3 * i
        rj, fac_j = newton(Sj.op64.vals * s, Sj.solver.op.vals * np.float32(s),
                           dplans, extra, aplans, jnp.asarray(b), fac_j)
        rt, fac_t = St.newton_step_warm(St.op64.vals * s,
                                        St.solver.op.vals * np.float32(s),
                                        b, fac_t)
        Ks = K.copy()
        Ks.data = K.data * s
        x = rt.x.numpy()
        assert rt.converged
        assert np.linalg.norm(Ks @ x - b) / np.linalg.norm(b) <= 1e-10, i
        assert abs(rt.iters - int(rj.iters)) <= 2, (i, rt.iters,
                                                    int(rj.iters))
        assert set(fac_t.full["levels"][0]) == set(FACTOR_KEYS)
