"""The port's dense inverses and coarse factorization against
hymls_tpu.core.dense on the CPU (where both take library LU inverses,
polished by Newton steps in f64), and the coarse factor's branch off the
CPU against the reference's accelerator branch.  Tolerances: 1e-10
relative in f64, 1e-5 in f32 on well-conditioned inputs."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hymls_tpu.core import dense as jdense
from hymls_tpu_torch.core import dense as tdense
from hymls_tpu_torch.utils import timings


def _spd_with_cond(n, cond, rng, batch=None):
    def one():
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        d = np.logspace(0, -np.log10(cond), n)
        return (Q * d) @ Q.T
    if batch is None:
        return one()
    return np.stack([one() for _ in range(batch)])


def _resid(A, X):
    return float(np.max(np.abs(np.eye(A.shape[-1]) - A @ X)))


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(ref - np.asarray(got, np.float64)).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("cond", [1e2, 1e5, 1e7])
def test_inv_newton_f64(cond):
    rng = np.random.default_rng(42)
    A = _spd_with_cond(24, cond, rng, batch=8)
    Xj = np.asarray(jdense.inv_newton(jnp.asarray(A)))
    Xt = tdense.inv_newton(torch.as_tensor(A)).numpy()
    # both polish to the attainable residual floor (~cond * eps64)
    assert _resid(A, Xt) < 10 * _resid(A, Xj) + 1e-13
    assert _rel(Xj, Xt) <= 1e-10 * cond


def test_inv_newton_f32():
    rng = np.random.default_rng(3)
    A = _spd_with_cond(16, 10.0, rng, batch=4).astype(np.float32)
    Xj = np.asarray(jdense.inv_newton(jnp.asarray(A)))
    Xt = tdense.inv_newton(torch.as_tensor(A))
    assert Xt.dtype == torch.float32
    assert _rel(Xj, Xt.numpy()) <= 1e-5


def test_newton_divergence_guard():
    """Beyond the f64 seed's reach the guard keeps the best iterate."""
    rng = np.random.default_rng(7)
    A = torch.as_tensor(_spd_with_cond(24, 1e10, rng))
    X0 = torch.linalg.inv(A.float()).double()
    r0 = _resid(A.numpy(), X0.numpy())
    X = tdense._newton_refine(A, X0, max_steps=6)
    assert torch.isfinite(X).all()
    assert _resid(A.numpy(), X.numpy()) <= r0 * (1 + 1e-9)


@pytest.mark.parametrize("n", [40, 2049])
def test_dense_factor_and_solve(n):
    """The inverse at n <= 2048, LU factors above; both solve like the
    reference."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    rhs = rng.standard_normal(n)
    fj = jdense.dense_factor(jnp.asarray(A))
    ft = tdense.dense_factor(torch.as_tensor(A))
    assert set(ft) == ({"inv"} if n <= 2048 else {"lu", "piv"})
    assert set(ft) == set(fj)
    yj = np.asarray(jdense.dense_solve(fj, jnp.asarray(rhs)))
    yt = tdense.dense_solve(ft, torch.as_tensor(rhs)).numpy()
    assert _rel(yj, yt) <= 1e-10
    Y = tdense.dense_solve(ft, torch.as_tensor(rhs[:, None].repeat(2, 1)))
    assert tuple(Y.shape) == (n, 2)
    assert _rel(yt, Y[:, 1].numpy()) <= 1e-12


def test_dense_factor_off_the_cpu_is_the_inverse():
    """A tensor off the CPU takes the inverse at every size: a 4096 x
    4096 system on the "meta" device (shapes only) gets no LU."""
    A = torch.empty(4096, 4096, dtype=torch.float32, device="meta")
    assert tdense.on_accelerator(A)
    assert not tdense.on_accelerator(torch.zeros(2, 2))
    fac = tdense.dense_factor(A)
    assert set(fac) == {"inv"}
    assert fac["inv"].shape == A.shape and fac["inv"].device.type == "meta"


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_dense_factor_accelerator_branch(dtype, monkeypatch):
    """Above 2048 unknowns the port's branch off the CPU (its predicate
    forced here) agrees with the reference's accelerator branch
    (`on_accelerator` forced true): an inverse, and its solve."""
    n = 2049
    rng = np.random.default_rng(n)
    A = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(dtype)
    rhs = rng.standard_normal(n).astype(dtype)
    monkeypatch.setattr(jdense, "on_accelerator", lambda: True)
    monkeypatch.setattr(tdense, "on_accelerator", lambda A: True)
    fj = jdense.dense_factor(jnp.asarray(A))
    ft = tdense.dense_factor(torch.as_tensor(A))
    assert set(ft) == set(fj) == {"inv"}
    assert ft["inv"].dtype == torch.as_tensor(A).dtype
    tol = 1e-10 if dtype == np.float64 else 1e-5
    assert _rel(fj["inv"], ft["inv"].numpy()) <= tol
    yj = np.asarray(jdense.dense_solve(fj, jnp.asarray(rhs)))
    yt = tdense.dense_solve(ft, torch.as_tensor(rhs)).numpy()
    assert _rel(yj, yt) <= tol
    assert _rel(np.linalg.solve(A.astype(np.float64), rhs), yt) <= tol


@pytest.mark.parametrize("n,counter", [(40, "hymls.coarse.inverse"),
                                       (2049, "hymls.coarse.lu")])
def test_dense_factor_counts_its_branch(n, counter):
    """Each factor `dense_factor` returns counts once, under its kind."""
    A = torch.eye(n, dtype=torch.float64) * 2.0
    before = timings.counter_snapshot()
    for _ in range(2):
        tdense.dense_factor(A)
    now = timings.counter_snapshot()
    delta = {k: now.get(k, 0) - before.get(k, 0)
             for k in ("hymls.coarse.inverse", "hymls.coarse.lu")}
    assert delta == {k: 2 if k == counter else 0 for k in delta}


@pytest.mark.parametrize("n,counter", [(40, "hymls.coarse.inverse"),
                                       (2049, "hymls.coarse.lu")])
def test_dense_refactor_counts_as_dense_factor(n, counter):
    """A refactor counts as `dense_factor` counts: an inverse warm from
    the last one, LU factors cold."""
    A = torch.eye(n, dtype=torch.float64) * 2.0
    prev = tdense.dense_factor(A)
    keys = ("hymls.coarse.inverse", "hymls.coarse.lu",
            "hymls.coarse.unknowns", "hymls.warm.polish")
    before = timings.counter_snapshot()
    fac = tdense.dense_refactor(A * 1.001, prev)
    now = timings.counter_snapshot()
    delta = {k: now.get(k, 0) - before.get(k, 0) for k in keys}
    warm = counter == "hymls.coarse.inverse"
    assert delta == {"hymls.coarse.inverse": int(warm),
                     "hymls.coarse.lu": int(not warm),
                     "hymls.coarse.unknowns": n,
                     "hymls.warm.polish": int(warm)}
    x = tdense.dense_solve(fac, torch.ones(n, dtype=torch.float64))
    assert torch.allclose(x, torch.full((n,), 1 / 2.002,
                                        dtype=torch.float64), rtol=1e-12)


def test_dense_solve_promotes_f32_factor():
    """An f32 inverse applied to an f64 vector computes in f64, as JAX
    promotes (the f64 Solver on the mixed solver's f32 preconditioner)."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((30, 30)) + 30 * np.eye(30)
    ft = tdense.dense_factor(torch.as_tensor(A, dtype=torch.float32))
    y = tdense.dense_solve(ft, torch.as_tensor(rng.standard_normal(30)))
    assert y.dtype == torch.float64


def test_inv_chain_hybrid_accuracy():
    """tests/test_dense.py::test_inv_chain_hybrid_accuracy on the port:
    `inv_chain(force_hybrid=True)` (f32 seed, one Newton step with the
    residual in f64 and the correction in f32) reaches the ~1e-9 class
    inverse residual on subdomain-interior-like conditioning, a hundred
    times below the f32 seed's, and agrees with the reference's hybrid
    inverse to 1e-7 relative (both carry an f32 seed's rounding,
    squared)."""
    rng = np.random.default_rng(7)
    A = _spd_with_cond(47, 1e4, rng, batch=8)
    X = tdense.inv_chain(torch.as_tensor(A), force_hybrid=True)
    assert X.dtype == torch.float64
    X = X.numpy()
    r = max(_resid(A[i], X[i]) for i in range(8))
    assert r < 3e-8, r
    X32 = torch.linalg.inv(torch.as_tensor(A, dtype=torch.float32))
    r32 = max(_resid(A[i], X32[i].double().numpy()) for i in range(8))
    assert r < r32 / 100
    Xj = np.asarray(jdense.inv_chain(jnp.asarray(A), force_hybrid=True))
    assert _rel(Xj, X) <= 1e-7


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_inv_chain_default_is_inv_newton(dtype):
    """Without `force_hybrid`, and for f32 input with it, the chain
    inverse is `inv_newton`: the branch the reference's CPU runs take."""
    rng = np.random.default_rng(9)
    A = torch.as_tensor(_spd_with_cond(20, 1e3, rng, batch=4), dtype=dtype)
    assert torch.equal(tdense.inv_chain(A), tdense.inv_newton(A))
    if dtype == torch.float32:
        assert torch.equal(tdense.inv_chain(A, force_hybrid=True),
                           tdense.inv_newton(A))
