"""The port's solvers, and the whole slice, against the JAX package.

f64 Krylov iteration counts must equal the reference's on the same
problem; the mixed-precision Newton step on cavity64_Re1000 (the
headline case of bench.py) must land within 2 inner f32 iterations of
the reference's count, measured here in the same test, at a true f64
relative residual <= 1e-11 (bench.py's relres_ok)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import hymls_tpu as H
from hymls_tpu.solvers.mixed import IterativeRefinementSolver as JIR
import hymls_tpu_torch as T
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver as TIR
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian


def _stokes_cfg(nx, tol=1e-12, maxiter=250, lor="Right"):
    """bench.py:_stokes_params(nx, 2, 1, "Cartesian"), generic apply."""
    return {"Problem": {"Equations": "Stokes-C", "Dimension": 2, "nx": nx,
                        "ny": nx},
            "Solver": {"Krylov Method": "GMRES",
                       "Left or Right Preconditioning": lor,
                       "Initial Vector": "Zero",
                       "Iterative Solver": {"Maximum Iterations": maxiter,
                                            "Convergence Tolerance": tol}},
            "Preconditioner": {"Partitioner": "Cartesian",
                               "Separator Length": 4,
                               "Number of Levels": 1,
                               "Structured Apply": False}}


def _cavity(nx):
    K = cavity_jacobian(nx, nx, re=1000.0).tocsr()
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    return K, b


def _relres(K, x, b):
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(K @ x - b) / np.linalg.norm(b))


def test_laplace1_cg_iterations():
    """Laplace 32^2, L=1, CG from a random start at 1e-10: the port
    takes exactly the reference's iterations (the laplace1 target is
    <= 21)."""
    d = {"Problem": {"Equations": "Laplace", "Dimension": 2, "nx": 32,
                     "ny": 32},
         "Solver": {"Krylov Method": "CG", "Initial Vector": "Random",
                    "Iterative Solver": {"Maximum Iterations": 100,
                                         "Convergence Tolerance": 1e-10}},
         "Preconditioner": {"Separator Length": 4, "Number of Levels": 1,
                            "Structured Apply": False}}
    K = create_matrix(T.Params(d))
    tv = create_testvector(T.Params(d), K)
    b = K @ np.random.default_rng(5).standard_normal(K.shape[0])
    Pj = H.Preconditioner(K, H.Params(d), testvector=tv).compute()
    _, rj = H.Solver(K, Pj, H.Params(d)).apply_inverse(b)
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv,
                          device="cpu").compute()
    x, rt = T.Solver(K, Pt, T.Params(d), device="cpu").apply_inverse(b)
    assert rt.converged
    assert rt.iters == int(rj.iters) <= 21
    assert _relres(K, x, b) < 5e-10


@pytest.mark.parametrize("lor", ["Right", "Left"])
def test_f64_gmres_counts_match_on_cavity32(lor):
    K, b = _cavity(32)
    d = _stokes_cfg(32, tol=1e-10, lor=lor)
    tv = create_testvector(T.Params(d), K)
    Pj = H.Preconditioner(K, H.Params(d), testvector=tv).compute()
    _, rj = H.Solver(K, Pj, H.Params(d)).apply_inverse(b)
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv,
                          device="cpu").compute()
    x, rt = T.Solver(K, Pt, T.Params(d), device="cpu").apply_inverse(b)
    assert rt.converged
    assert rt.iters == int(rj.iters)
    assert abs(rt.relres - float(rj.relres)) <= 1e-3 * float(rj.relres)
    if lor == "Right":
        assert _relres(K, x, b) <= 1e-9


def test_f64_gmres_on_f32_preconditioner():
    """bench.py's f64 parity solve: f64 GMRES on the mixed solver's f32
    preconditioner (the apply promotes to f64, as JAX does)."""
    K, b = _cavity(32)
    d = _stokes_cfg(32, tol=1e-10)
    tv = create_testvector(T.Params(d), K)
    Sj = JIR(K, H.Params(d), testvector=tv).compute()
    _, rj = H.Solver(K, Sj.precond, H.Params(d),
                     dtype=jnp.float64).apply_inverse(b)
    St = TIR(K, T.Params(d), testvector=tv, device="cpu").compute()
    x, rt = T.Solver(K, St.precond, T.Params(d),
                     device="cpu").apply_inverse(b)
    assert x.dtype == torch.float64
    assert abs(rt.iters - int(rj.iters)) <= 1
    assert _relres(K, x, b) <= 1e-9


def test_refinement_entry_points_on_cavity32():
    K, b = _cavity(32)
    d = _stokes_cfg(32, tol=1e-10)
    S = TIR(K, T.Params(d), device="cpu").compute()
    assert S.inner_maxiter == 64
    x = S.solve(b)
    assert S.num_iter > 0 and _relres(K, x, b) <= 1e-10
    x2, res = S.apply_inverse(b)
    assert res.converged and _relres(K, x2, b) <= 1e-10


@pytest.mark.parametrize("solver", [
    {"Deflated Subspace Dimension": 4},
    {"Distributed Apply": True},
    {"Krylov Method": "MINRES"},
])
def test_unported_solver_options_raise(solver):
    """These options raised NotImplementedError until their modules
    were ported.  None does now: the solver constructs, and without
    `setup_deflation()`, without a mesh and with a method name that is
    not "CG" it solves exactly as with the default options, as in the
    reference (tests/test_torch_deflation.py holds each against it).
    The test keeps the name it had while they raised; what it checks
    now is the port against itself, on the Stokes-C cavity rather than
    the Laplace cases of that file."""
    import warnings
    K, b = _cavity(16)
    d = _stokes_cfg(16)
    P = T.Preconditioner(K, T.Params(d), device="cpu")
    x0, r0 = T.Solver(K, P, T.Params(d), device="cpu").apply_inverse(b)
    for k, v in solver.items():
        if isinstance(v, dict):
            d["Solver"][k].update(v)
        else:
            d["Solver"][k] = v
    S = T.Solver(K, P, T.Params(d), device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x, res = S.apply_inverse(b)
    no_mesh = [w for w in caught if "no device mesh" in str(w.message)]
    assert len(no_mesh) == ("Distributed Apply" in solver)
    assert res.iters == r0.iters and torch.equal(x, x0)


def test_cavity64_newton_step_slice():
    """The whole slice on the headline case: f32 re-factorization from
    the f64 values, then the refinement solve; inner f32 iterations
    within 2 of the reference's fused Newton step, true f64 relres
    <= 1e-11."""
    K, b = _cavity(64)
    d = _stokes_cfg(64)
    tv = create_testvector(T.Params(d), K)

    Sj = JIR(K, H.Params(d), testvector=tv).compute()
    fn, dplans, extra, aplans = Sj.newton_step_fn()
    rj = fn(Sj.op64.vals, Sj.solver.op.vals, dplans, extra, aplans,
            jnp.asarray(b))
    iters_ref = int(rj.iters)
    assert _relres(K, rj.x, b) <= 1e-11

    St = TIR(K, T.Params(d), testvector=tv, device="cpu").compute()
    assert St.precond.coarse_plan.n == Sj.precond.coarse_plan.n
    rt = St.newton_step(St.op64.vals, St.solver.op.vals, b)
    assert rt.x.dtype == torch.float64 and rt.x.shape == (K.shape[0],)
    assert torch.isfinite(rt.x).all()
    assert rt.converged
    assert abs(rt.iters - iters_ref) <= 2, (rt.iters, iters_ref)
    assert _relres(K, rt.x, b) <= 1e-11
