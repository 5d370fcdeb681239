"""The port's direct-Schur mode ('Number of Levels' = 0) against the JAX
package's and against a sparse direct solve.

Laplace 16^2 (separator length 4) and Stokes-C 16^2 (separator length
8).  Both packages build identical plans; A11inv, G, A21 and the dense
Schur factor agree to 1e-10 relative; one `apply_inverse` is the exact
solve to 1e-12 against `scipy.sparse.linalg.spsolve`, plain, bordered
(the augmented system [K V; V' C]) and after a warm `recompute`; f64
GMRES needs the reference's iterations, at most 2.  The port's apply
also runs on the reference's own plans and factors
(hymls_tpu_torch.convert), plain and bordered, to 1e-12.

Stokes-C is singular (the constant pressure mode) and by default pins
the pressure of cell 0 in the Schur complement ('Fix GID 1'); one
apply is then no exact solve (GMRES needs 2 iterations), so that case
is held to the reference alone.  Its exact case turns the pin off and
borders K with the constant-pressure null space, which makes the
augmented system regular.
"""
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import torch

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu_torch.convert import direct_plan_from_numpy
from hymls_tpu_torch.core.preconditioner import DIRECT_FIELDS
from hymls_tpu_torch.stencils import create_nullspace

from _torch_parity import (rel, np_tree, problem, pair,
                           assert_plans_identical, assert_factors_agree,
                           on_ref_factors, solve_both, relres)


def _cfg(eqn, sep, **prec):
    return {"Problem": {"Equations": eqn, "Dimension": 2, "nx": 16,
                        "ny": 16},
            "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                       "Iterative Solver": {"Maximum Iterations": 20,
                                            "Convergence Tolerance": 1e-10}},
            "Preconditioner": {"Separator Length": sep,
                               "Number of Levels": 0, **prec}}


CASES = {"laplace16": lambda: _cfg("Laplace", 4),
         "stokes16_sep8": lambda: _cfg("Stokes-C", 8),
         "stokes16_sep8_nopin": lambda: _cfg(
             "Stokes-C", 8, **{"Fix Pressure Level": False})}
NAMES = ["laplace16", "stokes16_sep8"]
BORDERED = ["laplace16", "stokes16_sep8_nopin"]


@functools.lru_cache(maxsize=None)
def _built(name):
    d = CASES[name]()
    K, tv = problem(d)
    Pj, Pt = pair(d, K, tv)
    return d, K, tv, Pj, Pt


def _assert_exact(name, K, P, seed):
    """One apply of `P` against spsolve (the regular Laplace matrix
    only; see the module docstring for pinned Stokes)."""
    b = np.random.default_rng(seed).standard_normal(K.shape[0])
    x = P.apply_inverse(b).numpy()
    if "stokes" in name:
        assert P.direct_plan.fix_rows.size == 1
    else:
        x_ref = spla.spsolve(K.tocsc(), b)
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-12
    return b, x


def _border(name, d, K):
    """(V, C): two random columns for Laplace; for Stokes the
    constant-pressure null space with a zero corner."""
    if "stokes" in name:
        d = dict(d, Driver={"Null Space Type": "Constant P"})
        V = create_nullspace(T.Params(d), K.shape[0])
        return V, np.zeros((V.shape[1], V.shape[1]))
    V = np.random.default_rng(21).standard_normal((K.shape[0], 2))
    return V, np.array([[0.5, 0.1], [-0.2, 0.3]])


@pytest.mark.parametrize("name", NAMES)
def test_direct_plans_identical(name):
    _, _, _, Pj, Pt = _built(name)
    assert Pt.max_level == 0 and Pt.coarse_plan is None
    assert_plans_identical(Pj, Pt)
    ref = direct_plan_from_numpy(np_tree(Pj._ddirect), device="cpu")
    assert set(ref) == set(DIRECT_FIELDS) == set(Pt.extra_plan)
    for k in ref:
        assert torch.equal(ref[k], Pt.extra_plan[k]), k
    assert Pt._structured is None
    assert Pt._structured_reason == "direct-SC mode"


@pytest.mark.parametrize("name", NAMES)
def test_direct_factors_match_reference(name):
    _, _, _, Pj, Pt = _built(name)
    assert set(Pt.factors.full["levels"][0]) == {"A11inv", "G", "A21"}
    n_sep = Pt.plans[0].n_sep
    assert tuple(Pt.factors.full["coarse"]["inv"].shape) == (n_sep, n_sep)
    assert_factors_agree(Pj, Pt)


@pytest.mark.parametrize("name", NAMES)
def test_direct_is_the_exact_solve(name):
    _, K, _, Pj, Pt = _built(name)
    b, x = _assert_exact(name, K, Pt, 0)
    assert rel(Pj.apply_inverse(b), x) <= 1e-10


@pytest.mark.parametrize("name", NAMES)
def test_direct_gmres_needs_no_iterations_to_speak_of(name):
    d, K, _, Pj, Pt = _built(name)
    x_ex = np.random.default_rng(7).standard_normal(K.shape[0])
    if "stokes" in name:                 # K has the constant pressure mode
        x_ex[2::3] -= x_ex[2::3].mean()
    b = K @ x_ex
    (_, rj), (xt, rt) = solve_both(d, K, Pj, Pt, b)
    assert rt.converged and rt.iters == int(rj.iters) <= 2
    assert relres(K, xt, b) <= 1e-10


@pytest.mark.parametrize("name", NAMES)
def test_direct_recompute_is_exact(name):
    """recompute() at L = 0 is factorize(prev=): the warm inverses of
    new values are still those of an exact solve."""
    d, K, tv, _, _ = _built(name)
    Pj, Pt = pair(d, K, tv)
    K2 = K.copy()
    K2.data = K.data * (1.0 + 1e-3 * np.cos(np.arange(K.nnz)))
    Pt.recompute(K2)
    Pj.recompute(K2)
    b, x = _assert_exact(name, K2, Pt, 1)
    assert rel(Pj.apply_inverse(b), x) <= 1e-10
    assert_factors_agree(Pj, Pt)


@pytest.mark.parametrize("name", BORDERED)
def test_direct_bordered_is_the_exact_solve(name):
    d, K, tv, _, _ = _built(name)
    Pj, Pt = pair(d, K, tv, compute=False)
    V, C = _border(name, d, K)
    m = V.shape[1]
    Pj.set_border(V, None, C)
    Pt.set_border(V, None, C)
    Pj.compute()
    Pt.compute()
    n_sep = Pt.plans[0].n_sep
    assert tuple(Pt.factors.full["coarse"]["inv"].shape) == (n_sep + m,
                                                         n_sep + m)
    for key in ("Q1", "W1"):
        assert rel(Pj._factors["border"][key],
                   Pt.factors.full["border"][key].numpy()) <= 1e-10, key
    assert_factors_agree(Pj, Pt)

    rng = np.random.default_rng(2)
    b, t = rng.standard_normal(K.shape[0]), rng.standard_normal(m)
    x, s = Pt.apply_inverse_bordered(b, t)
    aug = sp.bmat([[K, sp.csr_matrix(V)],
                   [sp.csr_matrix(V.T), sp.csr_matrix(C)]]).tocsc()
    ref = spla.spsolve(aug, np.concatenate([b, t]))
    got = np.concatenate([x.numpy(), s.numpy()])
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-12
    xj, sj = Pj.apply_inverse_bordered(b, t)
    assert rel(xj, x.numpy()) <= 1e-10 and rel(sj, s.numpy()) <= 1e-10
    # the plain apply solves with a zero border right-hand side
    assert rel(Pj.apply_inverse(b), Pt.apply_inverse(b).numpy()) <= 1e-10

    # bordered GMRES through the Solver: the reference's iterations
    Sj = H.Solver(K, Pj, H.Params(d))
    St = T.Solver(K, Pt, T.Params(d), device="cpu")
    Sj.set_border(V, None, C)
    St.set_border(V, None, C)
    bb = K @ b
    _, rj = Sj.apply_inverse(bb, t=t)
    _, rt = St.apply_inverse(bb, t=t)
    assert rt.converged and rt.iters == int(rj.iters) <= 2
    assert np.abs(St._border_coeffs - Sj._border_coeffs).max() <= 1e-10


@pytest.mark.parametrize("bordered", [False, True],
                         ids=["plain", "bordered"])
@pytest.mark.parametrize("name", BORDERED)
def test_direct_apply_on_reference_factors(name, bordered):
    """The port's direct apply on the reference's own plans and factor
    tree, carried over by hymls_tpu_torch.convert."""
    d, K, tv, _, _ = _built(name)
    Pj, Pt = pair(d, K, tv, compute=False)
    if bordered:
        V, C = _border(name, d, K)
        Pj.set_border(V, None, C)
        Pt.set_border(V, None, C)
    Pj.compute()
    fac = on_ref_factors(Pt, Pj)
    assert ("border" in fac.tree) == bordered
    rng = np.random.default_rng(4)
    b = rng.standard_normal(K.shape[0])
    if bordered:
        t = rng.standard_normal(V.shape[1])
        xj, sj = Pj.apply_inverse_bordered(b, t)
        xt, st = Pt.apply_bordered_fn(fac, torch.as_tensor(b),
                                      torch.as_tensor(t))
        assert rel(sj, st.numpy()) <= 1e-12
    else:
        xj = Pj.apply_inverse(b)
        xt = Pt.apply_fn(fac, torch.as_tensor(b))
    assert rel(xj, xt.numpy()) <= 1e-12
