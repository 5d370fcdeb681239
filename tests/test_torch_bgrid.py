"""The B-grid transform in the port against the JAX package.

stokes_L2's setup at 8^3 (tests/test_bgrid.py:66-85, :123): Stokes on
the 3D L-grid, column subdomains, no dropping, L = 2, with and without
'B-Grid Transform'.  With it the preconditioner is built on
M = T' K T and every apply is T apply(T' b), T and T' as DIA operators
(three bands each).  Plans identical (they are built on M); factors to
1e-10 relative (`sc` against the scale of the matrix); M^{-1} b equal
to 1e-9 (the coarse level is nearly singular, see
tests/test_torch_nodrop.py); f64 GMRES counts equal; the config's
target (<= 80 iterations, relres < 1e-9); `compute(K)` and
`recompute(K)` transform new values as the constructor did.
"""
import functools

import numpy as np
import pytest

import torch

import hymls_tpu_torch as T
from hymls_tpu_torch.core.preconditioner import _build_bgrid_t
from hymls_tpu_torch.ops.spmv import DiaOperator
from hymls_tpu_torch.stencils import create_nullspace

from _torch_parity import (rel, problem, pair, relres,
                           assert_plans_identical, assert_factors_agree,
                           solve_both)


def _cfg(bgrid, nx=8):
    return {
        "Problem": {"Equations": "Stokes-L", "Dimension": 3,
                    "nx": nx, "ny": nx, "nz": nx, "Degrees of Freedom": 4},
        "Driver": {"Galeri Label": "Stokes-L"},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 200,
                                        "Convergence Tolerance": 1e-10}},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Fix Pressure Level": True,
                           "Apply Dropping": False,
                           "Separator Length (x)": 4,
                           "Separator Length (y)": 4,
                           "Separator Length (z)": nx,
                           "Coarsening Factor": 2,
                           "Number of Levels": 2,
                           "B-Grid Transform": bgrid}}


MODES = [False, True]
IDS = ["plain", "bgrid"]


@functools.lru_cache(maxsize=None)
def _built(bgrid):
    d = _cfg(bgrid)
    K, tv = problem(d)
    Pj, Pt = pair(d, K, tv)
    return d, K, tv, Pj, Pt


@pytest.mark.parametrize("bgrid", MODES, ids=IDS)
def test_bgrid_plans_and_factors_match_reference(bgrid):
    _, K, _, Pj, Pt = _built(bgrid)
    assert (Pt._bgrid is not None) == bgrid
    assert_plans_identical(Pj, Pt)
    assert rel(Pj.K.data, Pt.K.data) == 0.0          # both hold T' K T
    assert_factors_agree(Pj, Pt, scale=float(np.abs(K.data).max()))


@pytest.mark.parametrize("bgrid", MODES, ids=IDS)
def test_bgrid_apply_and_counts_match_reference(bgrid):
    d, K, _, Pj, Pt = _built(bgrid)
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    assert rel(Pj.apply_inverse(b), Pt.apply_inverse(b).numpy()) <= 1e-9
    (_, rj), (xt, rt) = solve_both(d, K, Pj, Pt, b)
    assert rt.converged and rt.iters == int(rj.iters)
    assert relres(K, xt, b) <= 1e-9


def test_bgrid_transform_is_a_rotation():
    """T is orthogonal, has three bands, and the conjugation's
    operators are DIA (the kernel's path on the card)."""
    _, K, _, _, Pt = _built(True)
    Tm = _build_bgrid_t(Pt.grid)
    assert abs(Tm.T @ Tm - np.eye(K.shape[0])).max() <= 1e-15
    for op in Pt._bgrid.ops:
        assert isinstance(op, DiaOperator) and op.offsets == (-1, 0, 1)
    x = np.random.default_rng(0).standard_normal(K.shape[0])
    Top, TopT = Pt._bgrid.ops
    assert rel(Tm @ x, Top(torch.as_tensor(x)).numpy()) <= 1e-15
    assert rel(Tm.T @ x, TopT(torch.as_tensor(x)).numpy()) <= 1e-15


def test_bgrid_f32_preconditioner_in_an_f64_solve():
    """An f32 preconditioner applied to f64 Krylov vectors promotes, as
    in the reference: the conjugation keeps bands per vector dtype."""
    d, K, tv, _, _ = _built(True)
    Pj, Pt = pair(d, K, tv, dtype=torch.float32)
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    (_, rj), (xt, rt) = solve_both(d, K, Pj, Pt, b)
    assert set(Pt._bgrid._bands) == {torch.float64}
    assert rt.converged and abs(rt.iters - int(rj.iters)) <= 2
    assert relres(K, xt, b) <= 1e-9


def test_stokes_l2_meets_the_config_target():
    """tests/test_bgrid.py::test_stokes_l2_bgrid_transform on the port."""
    d, K, _, _, Pt = _built(True)
    ns = create_nullspace(
        T.Params({"Problem": dict(d["Problem"]),
                  "Driver": {"Null Space Type": "Checkerboard"}}),
        K.shape[0])
    x_ex = np.random.default_rng(7).standard_normal(K.shape[0])
    x_ex -= ns @ (np.linalg.pinv(ns) @ x_ex)
    b = K @ x_ex
    x, res = T.Solver(K, Pt, T.Params(d), device="cpu").apply_inverse(b)
    x = x.numpy()
    x -= ns @ (np.linalg.pinv(ns) @ (x - x_ex))
    assert res.converged and res.iters <= 80
    assert relres(K, x, b) < 1e-9


@pytest.mark.parametrize("warm", [False, True], ids=["compute", "recompute"])
def test_bgrid_new_values_are_transformed(warm):
    d, K, tv, _, _ = _built(True)
    Pj, Pt = pair(d, K, tv)
    K2 = K.copy()
    K2.data = K.data * (1.0 + 1e-6)
    if warm:
        Pj.recompute(K2)
        Pt.recompute(K2)
    else:
        Pj.compute(K2)
        Pt.compute(K2)
    assert rel(Pj.K.data, Pt.K.data) == 0.0
    assert rel(Pt._transform_bgrid(K2).data, Pt.K.data) == 0.0
    assert_factors_agree(Pj, Pt, scale=float(np.abs(K.data).max()))
    b = K2 @ np.random.default_rng(5).standard_normal(K.shape[0])
    assert rel(Pj.apply_inverse(b), Pt.apply_inverse(b).numpy()) <= 1e-9
