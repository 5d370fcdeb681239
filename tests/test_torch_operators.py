"""The operator closures of the port (ops/operators.py) against dense
numpy, and against the JAX package's closures on the same inputs.

Every comparison is to 1e-13 relative to the result's largest entry
(f64; the closures only compose products and sums).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hymls_tpu.ops import operators as jops
from hymls_tpu_torch.ops import operators as tops
from hymls_tpu_torch.ops.spmv import make_operator
from hymls_tpu_torch.stencils import laplace2d

from _torch_parity import rel

TOL = 1e-13
N = 40


def _dense(seed, n=N):
    return np.random.default_rng(seed).standard_normal((n, n))


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _op(A):
    At = _t(A)
    return lambda x: At @ x


def _jop(A):
    Aj = jnp.asarray(A)
    return lambda x: Aj @ x


@pytest.mark.parametrize("a,b,with_B", [(1.0, 0.0, False), (2.5, -0.75, True),
                                        (1.0, 0.3, False), (-1.0, 2.0, True)])
def test_shifted_operator(a, b, with_B):
    """y = a A x + b B x; B = None is the identity, b = 0 skips B."""
    A, B = _dense(0), _dense(1)
    x = np.random.default_rng(2).standard_normal(N)
    want = a * (A @ x) + b * ((B @ x) if with_B else x)
    got = tops.shifted_operator(_op(A), _op(B) if with_B else None,
                                a, b)(_t(x))
    assert rel(want, got.numpy()) <= TOL
    ref = jops.shifted_operator(_jop(A), _jop(B) if with_B else None,
                                a, b)(jnp.asarray(x))
    assert rel(np.asarray(ref), got.numpy()) <= TOL


@pytest.mark.parametrize("k", [1, 2, 3])
def test_product_operator(k):
    """x -> Op_1(Op_2(... Op_k(x))): the last operator acts first."""
    mats = [_dense(10 + j) / np.sqrt(N) for j in range(k)]
    x = np.random.default_rng(3).standard_normal(N)
    want = x
    for A in reversed(mats):
        want = A @ want
    got = tops.product_operator(*[_op(A) for A in mats])(_t(x))
    assert rel(want, got.numpy()) <= TOL
    ref = jops.product_operator(*[_jop(A) for A in mats])(jnp.asarray(x))
    assert rel(np.asarray(ref), got.numpy()) <= TOL


@pytest.mark.parametrize("oblique", [False, True])
def test_projected_operator(oblique):
    """(I - V W') A (I - V W'); W = None means W = V."""
    rng = np.random.default_rng(4)
    A = _dense(5)
    V = np.linalg.qr(rng.standard_normal((N, 4)))[0]
    W = None
    if oblique:
        W = rng.standard_normal((N, 4))
        W = W @ np.linalg.inv(V.T @ W)          # W'V = I
    x = rng.standard_normal(N)
    Pm = np.eye(N) - V @ (V if W is None else W).T
    want = Pm @ (A @ (Pm @ x))
    got = tops.projected_operator(_op(A), _t(V),
                                  None if W is None else _t(W))(_t(x))
    assert rel(want, got.numpy()) <= TOL
    ref = jops.projected_operator(
        _jop(A), jnp.asarray(V),
        None if W is None else jnp.asarray(W))(jnp.asarray(x))
    assert rel(np.asarray(ref), got.numpy()) <= TOL
    if W is None:
        # the projected operator maps into the complement of V
        assert np.abs(V.T @ got.numpy()).max() <= 1e-12


def test_closures_compose_on_sparse_operators():
    """The closures take the port's operators as they are: the shifted
    pencil K - sigma M of the eigenvalue solves, projected against a
    block, on a DIA and an ELL operator."""
    from hymls_tpu_torch.ops.spmv import EllOperator
    K = laplace2d(8, 8).tocsr()
    n = K.shape[0]
    rng = np.random.default_rng(6)
    import scipy.sparse as sp
    M = sp.diags(1.0 + rng.random(n)).tocsr()
    opK = make_operator(K, device="cpu")
    opM = EllOperator(M, device="cpu")
    V = np.linalg.qr(rng.standard_normal((n, 3)))[0]
    x = rng.standard_normal(n)
    sigma = 0.37
    op = tops.projected_operator(
        tops.shifted_operator(opK, opM, 1.0, -sigma), _t(V))
    Pm = np.eye(n) - V @ V.T
    want = Pm @ ((K - sigma * M) @ (Pm @ x))
    assert rel(want, op(_t(x)).numpy()) <= TOL
