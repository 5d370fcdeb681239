"""'Apply Dropping' = false in the port against the JAX package.

Stokes-B 32^2, Cartesian, L = 2, coarsening 2 (tests/test_bgrid.py's
stokes_B setup) and skew Stokes-C 16^2, L = 2: no Householder transform
and the whole Schur complement on every level.  Plans identical; every
factor to 1e-10 relative in f64 (`sc` against the scale of the matrix:
entries that cancel to rounding have no relative accuracy); f64 GMRES
iteration counts equal; the config's targets (<= 60 iterations, relres
and error < 1e-9 after projecting the checkerboard modes out).

Without dropping the coarse level holds the pinned, nearly singular
pressure operator (its condition number is ~2e10 on Stokes-B 32^2), so
rounding in M^{-1} b is amplified along the pressure modes: the applies
are held to 1e-6 relative, and to 1e-10 after K has removed those modes
(K M^{-1} b).  The port's apply on the reference's own factors differs
only by the apply's rounding, held to the same two bounds.

"Auto" leaves the structured program off with the reference's reason
and runs the generic apply; the bordered levels take the switch too.
"""
import functools

import numpy as np
import pytest

import torch

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu_torch.stencils import create_nullspace

from _torch_parity import (rel, problem, pair, relres, on_ref_factors,
                           assert_plans_identical, assert_factors_agree,
                           solve_both)

SOLVER = {"Krylov Method": "GMRES",
          "Left or Right Preconditioning": "Right",
          "Initial Vector": "Zero",
          "Iterative Solver": {"Maximum Iterations": 200,
                               "Convergence Tolerance": 1e-10}}


def _stokes_b():
    return {"Problem": {"Equations": "Stokes-B", "Dimension": 2,
                        "nx": 32, "ny": 32, "Degrees of Freedom": 3},
            "Solver": SOLVER,
            "Preconditioner": {"Partitioner": "Cartesian",
                               "Fix Pressure Level": True,
                               "Apply Dropping": False,
                               "Separator Length": 8,
                               "Coarsening Factor": 2,
                               "Number of Levels": 2}}


def _skew16():
    return {"Problem": {"Equations": "Stokes-C", "Dimension": 2,
                        "nx": 16, "ny": 16},
            "Solver": SOLVER,
            "Preconditioner": {"Partitioner": "Skew Cartesian",
                               "Apply Dropping": False,
                               "Separator Length": 4,
                               "Number of Levels": 2}}


CASES = {"stokesB32_L2": _stokes_b, "skew_stokes16_L2": _skew16}
NAMES = list(CASES)


@functools.lru_cache(maxsize=None)
def _built(name):
    d = CASES[name]()
    K, tv = problem(d)
    Pj, Pt = pair(d, K, tv)
    return d, K, tv, Pj, Pt


def _assert_applies_agree(K, yj, yt):
    assert rel(yj, yt) <= 1e-6
    assert rel(K @ np.asarray(yj), K @ np.asarray(yt)) <= 1e-10


@pytest.mark.parametrize("name", NAMES)
def test_nodrop_plans_identical(name):
    _, _, _, Pj, Pt = _built(name)
    assert not any(p.apply_ot for p in Pt.plans)
    assert_plans_identical(Pj, Pt)


@pytest.mark.parametrize("name", NAMES)
def test_nodrop_auto_runs_the_generic_apply(name):
    _, _, _, Pj, Pt = _built(name)
    assert Pt._structured is None and not Pt._structured_active
    assert Pt._structured_reason == Pj._structured_reason == \
        "Apply Dropping == false"
    assert not Pt.factors.structured
    assert Pt.factors.plans is Pt.generic_plans


@pytest.mark.parametrize("name", NAMES)
def test_nodrop_factors_match_reference(name):
    _, K, _, Pj, Pt = _built(name)
    assert_factors_agree(Pj, Pt, scale=float(np.abs(K.data).max()))
    # no reflectors and no non-Vsum blocks without dropping
    for f in Pt.factors.full["levels"]:
        assert f["blkinv"].shape[0] == 0


@pytest.mark.parametrize("name", NAMES)
def test_nodrop_apply_matches_reference(name):
    _, K, _, Pj, Pt = _built(name)
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    yj = np.asarray(Pj.apply_inverse(b))
    _assert_applies_agree(K, yj, Pt.apply_inverse(b).numpy())
    # the port's V-cycle on the reference's own plans and factors
    yc = Pt.apply_fn(on_ref_factors(Pt, Pj), torch.as_tensor(b))
    _assert_applies_agree(K, yj, yc.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_nodrop_gmres_counts_match_reference(name):
    d, K, _, Pj, Pt = _built(name)
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    (_, rj), (xt, rt) = solve_both(d, K, Pj, Pt, b)
    assert rt.converged and rt.iters == int(rj.iters)
    assert relres(K, xt, b) <= 1e-9


def test_stokes_b_meets_the_config_targets():
    """tests/test_bgrid.py::test_stokes_b_no_dropping on the port."""
    d, K, _, _, Pt = _built("stokesB32_L2")
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
    assert res.converged and res.iters <= 60
    assert relres(K, x, b) < 1e-9
    assert np.linalg.norm(x - x_ex) / np.linalg.norm(b) < 1e-9


def test_nodrop_bordered_matches_reference():
    """The bordered levels without dropping: border factors, the
    bordered apply and the bordered f64 GMRES count."""
    d = _skew16()
    d["Preconditioner"]["Fix Pressure Level"] = False
    d["Driver"] = {"Null Space Type": "Constant P"}
    K, tv = problem(d)
    ns = create_nullspace(T.Params(d), K.shape[0])
    Pj, Pt = pair(d, K, tv, compute=False)
    Sj = H.Solver(K, Pj, H.Params(d))
    St = T.Solver(K, Pt, T.Params(d), device="cpu")
    Sj.set_border(ns)
    St.set_border(ns)
    Pj.compute()
    Pt.compute()
    for fj, ft in zip(Pj._factors["levels"], Pt.factors.full["levels"]):
        for key in ("Q1", "W1", "bW"):
            assert rel(fj["border"][key], ft["border"][key].numpy()) <= 1e-10
    assert rel(Pj._factors["coarse"]["inv"],
               Pt.factors.full["coarse"]["inv"].numpy()) <= 1e-10
    rng = np.random.default_rng(11)
    b, t = rng.standard_normal(K.shape[0]), rng.standard_normal(ns.shape[1])
    xj, sj = Pj.apply_inverse_bordered(b, t)
    xt, st = Pt.apply_inverse_bordered(b, t)
    assert rel(xj, xt.numpy()) <= 1e-10 and rel(sj, st.numpy()) <= 1e-10

    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    rhs = K @ x_ex
    _, rj = Sj.apply_inverse(rhs)
    xs, rt = St.apply_inverse(rhs)
    assert rt.converged and rt.iters == int(rj.iters)
    assert relres(K, xs.numpy(), rhs) <= 1e-9
