"""The port's bordered solve [K V; W' C] against the JAX package's, on
the four bordered setups of tests/test_bordered.py (Neumann Laplace
32^2 L = 2 with the constant border; Stokes-C 32^2, Cartesian and skew,
and periodic skew Stokes-C 16^2, with their null-space borders):

  * the border factors of every level (Q1, W1, bW), the augmented
    coarse factor and `apply_inverse_bordered` agree with the
    reference's to 1e-10 relative in f64;
  * f64 GMRES takes exactly the reference's iterations (the Random
    start vector comes from the same default_rng(42)), and the border
    coefficients agree to 1e-10 absolute (they are ~1e-15: the
    right-hand sides are consistent);
  * while a border is set the structured program is inactive, as in the
    reference, and it is active again after set_border(None).
"""
import functools

import numpy as np
import pytest

import torch

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver as TIR
from hymls_tpu_torch.stencils import (laplace2d_neumann, create_matrix,
                                      create_testvector, create_nullspace)

BORDER_KEYS = ("Q1", "W1", "bW")


def _cfg(eqn, nx, nullspace, lor, initial, maxiter, tol, levels,
         partitioner=None, periodic=False):
    prob = {"Equations": eqn, "Dimension": 2, "nx": nx, "ny": nx}
    if periodic:
        prob.update({"x-periodic": True, "y-periodic": True})
    prec = {"Separator Length": 4, "Number of Levels": levels}
    if partitioner:
        prec.update({"Partitioner": partitioner,
                     "Fix Pressure Level": False})
    return {"Problem": prob,
            "Driver": {"Null Space Type": nullspace},
            "Solver": {"Krylov Method": "GMRES",
                       "Left or Right Preconditioning": lor,
                       "Initial Vector": initial,
                       "Iterative Solver": {"Maximum Iterations": maxiter,
                                            "Convergence Tolerance": tol}},
            "Preconditioner": prec}


# name -> (config, x_ex seed); tests/test_bordered.py:14-153
CASES = {
    "neumann_laplace32_L2": (
        lambda: _cfg("Laplace", 32, "Constant", "Left", "Random", 100,
                     1e-10, 2), 3),
    "cavity_style_stokes32": (
        lambda: _cfg("Stokes-C", 32, "Constant P", "Left", "Zero", 250,
                     1e-12, 1, "Cartesian"), 7),
    "skew_stokes32": (
        lambda: _cfg("Stokes-C", 32, "Constant P", "Right", "Zero", 100,
                     1e-10, 1, "Skew Cartesian"), 9),
    "periodic_skew_stokes16": (
        lambda: _cfg("Stokes-C", 16, "Constant", "Left", "Zero", 150,
                     1e-10, 1, "Skew Cartesian", periodic=True), 3),
}


def _problem(name):
    cfg, seed = CASES[name]
    d = cfg()
    if name.startswith("neumann"):
        K = laplace2d_neumann(32, 32)
    else:
        K = create_matrix(T.Params(d))
    K = K.tocsr()
    tv = create_testvector(T.Params(d), K)
    ns = create_nullspace(T.Params(d), K.shape[0])
    rng = np.random.default_rng(seed)
    x_ex = rng.standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    return d, K, tv, ns, K @ x_ex


@functools.lru_cache(maxsize=None)
def _solved(name):
    """Both packages' bordered preconditioner and solver, after one
    solve of the case; built once per case and only read by the
    tests."""
    d, K, tv, ns, b = _problem(name)
    Pj = H.Preconditioner(K, H.Params(d), testvector=tv)
    Sj = H.Solver(K, Pj, H.Params(d))
    Sj.set_border(ns)
    Pj.compute()
    xj, rj = Sj.apply_inverse(b)

    Pt = T.Preconditioner(K, T.Params(d), testvector=tv, device="cpu")
    St = T.Solver(K, Pt, T.Params(d), device="cpu")
    St.set_border(ns)
    Pt.compute()
    xt, rt = St.apply_inverse(b)
    return K, b, (Pj, Sj, np.asarray(xj), rj), (Pt, St, xt, rt)


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("name", list(CASES))
def test_border_factors_match_reference(name):
    K, _, (Pj, *_), (Pt, *_) = _solved(name)
    assert len(Pt.factors.full["levels"]) == len(Pj._factors["levels"])
    for lev, (fj, ft) in enumerate(zip(Pj._factors["levels"],
                                       Pt.factors.full["levels"])):
        for key in BORDER_KEYS:
            assert _rel(fj["border"][key], ft["border"][key]) <= 1e-10, \
                (lev, key)
    m = Pt._border[0].shape[1]
    cj, ct = Pj._factors["coarse"]["inv"], Pt.factors.full["coarse"]["inv"]
    assert ct.shape[0] == Pt.coarse_plan.n + m
    assert _rel(cj, ct) <= 1e-10

    rng = np.random.default_rng(11)
    b, t = rng.standard_normal(K.shape[0]), rng.standard_normal(m)
    xj, sj = Pj.apply_inverse_bordered(b, t)
    xt, st = Pt.apply_inverse_bordered(b, t)
    assert _rel(xj, xt) <= 1e-10 and _rel(sj, st) <= 1e-10
    # the plain apply solves with a zero border right-hand side
    assert _rel(Pj.apply_inverse(b), Pt.apply_inverse(b)) <= 1e-10


@pytest.mark.parametrize("name", list(CASES))
def test_bordered_gmres_matches_reference(name):
    K, b, (_, Sj, xj, rj), (_, St, xt, rt) = _solved(name)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    assert xt.shape == (K.shape[0],) and xt.dtype == torch.float64
    assert isinstance(St._border_coeffs, np.ndarray)
    assert St._border_coeffs.shape == Sj._border_coeffs.shape == \
        (St._border[0].shape[1],)
    assert np.abs(St._border_coeffs - Sj._border_coeffs).max() <= 1e-10
    relres = np.linalg.norm(K @ xt.numpy() - b) / np.linalg.norm(b)
    assert relres <= max(1e-7, 10 * np.linalg.norm(K @ xj - b)
                         / np.linalg.norm(b))


def test_structured_apply_is_inactive_while_bordered():
    """The reference's `_structured_active` is false whenever a border is
    set; the port used to ignore the border."""
    name = "cavity_style_stokes32"
    d, K, tv, ns, b = _problem(name)
    P = T.Preconditioner(K, T.Params(d), testvector=tv, device="cpu")
    plain = T.Preconditioner(K, T.Params(d), testvector=tv,
                             device="cpu").compute()
    assert P._structured is not None and P._structured_active
    S = T.Solver(K, P, T.Params(d), device="cpu")
    S.set_border(ns)
    assert not P._structured_active
    x, res = S.apply_inverse(b)
    fac = P.factors
    assert res.converged and not fac.structured
    assert fac.plans is not P._structured.consts
    assert "border" in fac.tree["levels"][0]

    S.set_border(None)
    assert S._border is None and P._border is None
    assert P._structured_active
    y = P.apply_inverse(b)
    assert P.factors.structured and P.factors.plans is P._structured.consts
    assert _rel(plain.apply_inverse(b), y) <= 1e-12
    x2, res2 = S.apply_inverse(b)
    assert res2.converged and S._border_coeffs is None


def test_mixed_solver_set_border_delegates():
    d, K, tv, ns, _ = _problem("cavity_style_stokes32")
    S = TIR(K, T.Params(d), testvector=tv, device="cpu")
    assert S.set_border(ns) is S
    assert S.solver._border is not None and S.precond._border is not None
    assert S.solver._border[0].dtype == torch.float32
    assert not S.precond._structured_active


def test_previous_start_vector_matches_reference():
    """'Initial Vector' = 'Previous' starts each solve from the last
    solution; a second solve of the same system starts converged."""
    d, K, tv, _, b = _problem("skew_stokes32")
    d["Solver"]["Initial Vector"] = "Previous"
    Pj = H.Preconditioner(K, H.Params(d), testvector=tv).compute()
    Sj = H.Solver(K, Pj, H.Params(d))
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv,
                          device="cpu").compute()
    St = T.Solver(K, Pt, T.Params(d), device="cpu")
    for rhs in (b, b, 2.0 * b):
        _, rj = Sj.apply_inverse(rhs)
        xt, rt = St.apply_inverse(rhs)
        assert rt.iters == int(rj.iters)
    assert torch.equal(St._prev_x, xt)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_bordered_cavity32_on_the_card(cuda_device):
    """The bordered Stokes-C 32^2 solve on the card launches the DIA
    kernel in its GMRES iterations and takes the CPU's iterations."""
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    name = "cavity_style_stokes32"
    d, K, tv, ns, b = _problem(name)
    P = T.Preconditioner(K, T.Params(d), testvector=tv, device=cuda_device)
    S = T.Solver(K, P, T.Params(d), device=cuda_device)
    S.set_border(ns)
    P.compute()
    dia_matvec.launches = 0
    x, res = S.apply_inverse(b)
    torch.cuda.synchronize()
    assert dia_matvec.launches > 0
    _, _, _, (_, _, _, rt) = _solved(name)
    assert res.converged and abs(res.iters - rt.iters) <= 1
    assert np.linalg.norm(K @ x.cpu().numpy() - b) / np.linalg.norm(b) \
        <= 1e-10
