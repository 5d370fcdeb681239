"""The eigenvalue solvers of the port (`JDQR`, `shift_invert_eigs`)
against the JAX package, f64 on the CPU.

The three cases of tests/test_eigen.py with their own assertions, the
eigenvalues within 1e-8 of the reference's and the outer iterations
within 3; the one data-free case found that reaches the conjugate-pair
correction solver (the lid-driven cavity Jacobian at 16^2, Re 1000:
a complex pair locked in both packages, values within 1e-6 of the
largest |lambda|); and JDQR on a bordered preconditioner with
'Bordered Solver' false and true.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu.solvers.eigen import JDQR as JJDQR
from hymls_tpu.solvers.eigen import shift_invert_eigs as jshift_invert_eigs
from hymls_tpu_torch.solvers.eigen import (EigenResult, JDQR,
                                           shift_invert_eigs)
from hymls_tpu_torch.stencils import laplace2d
from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian

from _torch_parity import laplace_cfg, neumann_setup, pair

VAL_TOL = 1e-8         # eigenvalues, port against reference
ITER_TOL = 3           # outer iterations, port against reference


def _cfg(nx, eig=None, equations="Laplace", drv=None):
    e = {"How Many": 10, "Which": "SM", "Convergence Tolerance": 1e-8,
         "Number of Iterations": 100, "Maximum Subspace Dimension": 40,
         "Restart Dimension": 20}
    e.update(eig or {})
    d = laplace_cfg(nx, levels=1, drv={"Eigenvalues": e,
                                          **(drv or {})})
    d["Problem"]["Equations"] = equations
    return d


def _sorted(vals):
    return np.sort_complex(np.asarray(vals, dtype=complex))


def _both(K, M, d, Pj, Pt):
    rj = JJDQR(K, M, Pj, H.Params(d)).solve()
    jd = JDQR(K, M, Pt, T.Params(d), device="cpu")
    return rj, jd.solve(), jd


@pytest.fixture(scope="module")
def laplace32():
    K = laplace2d(32, 32).tocsr()
    d = _cfg(32)
    Pj, Pt = pair(d, K, None)
    ref = np.sort(np.abs(np.real(spla.eigs(
        K.asfptype(), k=10, sigma=0, which="LM",
        return_eigenvectors=False))))
    return K, d, Pj, Pt, ref


def test_jdqr_laplace_eigs(laplace32):
    K, d, Pj, Pt, ref = laplace32
    rj, rt, jd = _both(K, None, d, Pj, Pt)
    assert isinstance(rt, EigenResult)
    # tests/test_eigen.py::test_jdqr_laplace_eigs's assertions
    assert rt.converged == 10
    assert rt.iterations <= 70
    got = np.sort(np.abs(rt.values))
    assert np.abs(got - ref).max() < 1e-8
    for j in range(rt.converged):
        u, lam = rt.vectors[:, j], rt.values[j]
        assert np.linalg.norm(K @ u - lam * u) < 1e-7
    # against the reference
    assert rj.converged == 10
    assert np.abs(got - np.sort(np.abs(rj.values))).max() <= VAL_TOL
    assert abs(rt.iterations - rj.iterations) <= ITER_TOL
    assert len(rt.residuals) == rt.iterations
    assert jd.corrections["real"] > 0 and jd.corrections["pair"] == 0


def test_shift_invert_eigs(laplace32):
    K, d, Pj, Pt, ref = laplace32
    St = T.Solver(K, Pt, T.Params(d), device="cpu")
    rt = shift_invert_eigs(K, None, St, k=10, target=0.0, tol=1e-10)
    got = np.sort(np.abs(np.real(rt.values)))
    assert np.abs(got - ref).max() < 1e-8
    assert rt.converged == 10 and rt.iterations == -1
    assert rt.vectors.shape == (K.shape[0], 10)
    rj = jshift_invert_eigs(K, None, H.Solver(K, Pj, H.Params(d)), k=10,
                            target=0.0, tol=1e-10)
    assert np.abs(got - np.sort(np.abs(np.real(rj.values)))).max() \
        <= VAL_TOL


def test_jdqr_generalized():
    """K x = lambda M x with a scaled lumped mass M."""
    K = laplace2d(16, 16).tocsr()
    n = K.shape[0]
    d = _cfg(16, eig={"How Many": 6})
    Pj, Pt = pair(d, K, None)
    M = sp.diags(1.0 + 0.5 * np.random.default_rng(4).random(n)).tocsr()
    rj, rt, _jd = _both(K, M, d, Pj, Pt)
    assert rt.converged >= 6
    ref = np.sort(np.abs(np.real(spla.eigs(
        K.asfptype(), k=6, M=M.asfptype(), sigma=0, which="LM",
        return_eigenvectors=False))))
    got = np.sort(np.abs(rt.values))[:6]
    assert np.abs(got - ref[:len(got)]).max() < 1e-8
    for j in range(6):
        u, lam = rt.vectors[:, j], rt.values[j]
        assert np.linalg.norm(K @ u - lam * (M @ u)) < 1e-7
    assert np.abs(got - np.sort(np.abs(rj.values))[:6]).max() <= VAL_TOL
    assert abs(rt.iterations - rj.iterations) <= ITER_TOL


def test_jdqr_conjugate_pair():
    """The cavity Jacobian at 16^2, Re 1000: the fourth Ritz value is
    one of a conjugate pair, so both packages go through the complex
    correction solver and lock the pair."""
    K = cavity_jacobian(16, 16, re=1000.0).tocsr()
    d = _cfg(16, equations="Stokes-C",
             eig={"How Many": 4, "Convergence Tolerance": 1e-6,
                  "Number of Iterations": 80,
                  "Maximum Subspace Dimension": 30,
                  "Restart Dimension": 12})
    Pj, Pt = pair(d, K, None)
    rj, rt, jd = _both(K, None, d, Pj, Pt)
    assert rj.converged == 4 and rt.converged == 4
    assert jd.corrections["pair"] > 0
    for r in (rj, rt):
        imag = np.imag(np.asarray(r.values, dtype=complex))
        assert (np.abs(imag) > 1e-6).sum() == 2      # one locked pair
        assert abs(imag.sum()) < 1e-12               # conjugates
    scale = np.abs(rj.values).max()
    assert np.abs(_sorted(rt.values) - _sorted(rj.values)).max() \
        <= 1e-6 * scale
    assert abs(rt.iterations - rj.iterations) <= ITER_TOL
    assert rt.vectors.dtype == np.complex128
    for j in range(4):
        u, lam = rt.vectors[:, j], rt.values[j]
        assert np.linalg.norm(K @ u - lam * u) < 1e-5


@pytest.mark.parametrize("use_bordered", [False, True])
def test_jdqr_on_bordered_preconditioner(use_bordered):
    """The Neumann Laplace 16^2, its preconditioner bordered with the
    constant null space.  'Bordered Solver' false refactors once
    without the border and corrects with the plain V-cycle; true
    corrects through the bordered V-cycle.  Both find the reference's
    eigenvalues (the singular plain factorization of the first makes
    its outer iterations depend on rounding, so only the second's
    count is compared)."""
    d, K, tv, ns = neumann_setup(nx=16, levels=1)
    d["Driver"]["Eigenvalues"] = _cfg(
        16, eig={"How Many": 4, "Bordered Solver": use_bordered}
    )["Driver"]["Eigenvalues"]
    Pj, Pt = pair(d, K, tv, compute=False)
    Pj.set_border(ns)
    Pt.set_border(ns)
    Pj.compute()
    Pt.compute()
    rj, rt, jd = _both(K, None, d, Pj, Pt)
    assert jd.use_bordered is use_bordered
    assert rt.converged == 4 and rj.converged == 4
    assert np.abs(_sorted(rt.values) - _sorted(rj.values)).max() <= VAL_TOL
    assert np.abs(np.asarray(rt.values)).min() < 1e-8      # the null mode
    for j in range(4):
        u, lam = rt.vectors[:, j], rt.values[j]
        assert np.linalg.norm(K @ u - lam * u) < 1e-7
    if use_bordered:
        assert abs(rt.iterations - rj.iterations) <= ITER_TOL
    # the border stays on the preconditioner
    assert Pt._border is not None


def test_jdqr_which_and_start_vector():
    """'Which' LM targets the other end of the spectrum, and a given
    start vector is used: the reference's two values (the Laplace
    operator's largest in magnitude, to 1e-6) in as many iterations."""
    K16 = laplace2d(16, 16).tocsr()
    d = _cfg(16, eig={"How Many": 2, "Which": "LM",
                      "Convergence Tolerance": 1e-6})
    Pj, Pt = pair(d, K16, None)
    v0 = np.random.default_rng(3).standard_normal(K16.shape[0])
    rj = JJDQR(K16, None, Pj, H.Params(d)).solve(v0)
    rt = JDQR(K16, None, Pt, T.Params(d), device="cpu").solve(v0)
    assert rt.converged == rj.converged == 2
    assert np.abs(_sorted(rt.values) - _sorted(rj.values)).max() <= VAL_TOL
    top = np.sort(np.linalg.eigvalsh(K16.toarray()))[:2]
    assert np.abs(np.sort(rt.values) - top).max() <= 1e-6
    assert abs(rt.iterations - rj.iterations) <= ITER_TOL
