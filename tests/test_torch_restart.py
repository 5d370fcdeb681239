"""Restarted GMRES ('Num Blocks') in the port against the JAX package.

tests/test_bordered.py::test_restarted_gmres_num_blocks's setup
(Laplace 32^2, L = 1, 'Num Blocks' 8, tolerance 1e-10): the port's host
loop over cycles takes exactly the reference's f64 iterations, with
left and right preconditioning, with a random start vector and on a
bordered solve; the convergence scale is that of the whole solve, not
of a cycle.  A restart length at or above 'Maximum Iterations' is full
GMRES.  `IterativeRefinementSolver` takes any 'Num Blocks': its
refinement loop never restarts, its `apply_inverse` passes do.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu.solvers import krylov as jkrylov
from hymls_tpu.solvers.mixed import IterativeRefinementSolver as JIR
from hymls_tpu_torch.solvers import krylov
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver as TIR
from hymls_tpu_torch.stencils import (laplace2d, laplace2d_neumann,
                                      create_testvector, create_nullspace)
from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian

from _torch_parity import rel, relres


def _cfg(lor="Left", initial="Zero", blocks=8, maxiter=100, levels=1,
         null_space=None):
    return {"Problem": {"Equations": "Laplace", "Dimension": 2,
                        "nx": 32, "ny": 32},
            "Driver": {"Null Space Type": null_space} if null_space else {},
            "Solver": {"Krylov Method": "GMRES", "Initial Vector": initial,
                       "Left or Right Preconditioning": lor,
                       "Iterative Solver": {"Maximum Iterations": maxiter,
                                            "Convergence Tolerance": 1e-10,
                                            "Num Blocks": blocks}},
            "Preconditioner": {"Separator Length": 4,
                               "Number of Levels": levels}}


def _both(d, K, border=None):
    Pj = H.Preconditioner(K, H.Params(d))
    Pt = T.Preconditioner(K, T.Params(d), device="cpu")
    Sj = H.Solver(K, Pj, H.Params(d))
    St = T.Solver(K, Pt, T.Params(d), device="cpu")
    if border is not None:
        Sj.set_border(border)
        St.set_border(border)
    Pj.compute()
    Pt.compute()
    return Sj, St


@pytest.mark.parametrize("initial", ["Zero", "Random"])
@pytest.mark.parametrize("lor", ["Left", "Right"])
def test_restarted_counts_match_reference(lor, initial):
    K = laplace2d(32, 32).tocsr()
    d = _cfg(lor, initial)
    Sj, St = _both(d, K)
    assert St.restart == 8
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    xj, rj = Sj.apply_inverse(b)
    xt, rt = St.apply_inverse(b)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    assert 8 < rt.iters <= 40             # more than one cycle
    assert abs(rt.relres - float(rj.relres)) <= 1e-6 * rt.relres
    assert rel(xj, xt.numpy()) <= 1e-10
    assert relres(K, xt.numpy(), b) < 1e-9


def test_restarted_bordered_counts_match_reference():
    """The bordered solve restarts too: Neumann Laplace 32^2, L = 2,
    with the constant border (tests/test_bordered.py:14-40)."""
    K = laplace2d_neumann(32, 32).tocsr()
    d = _cfg("Left", "Zero", levels=2, null_space="Constant")
    ns = create_nullspace(T.Params(d), K.shape[0])
    x_ex = np.random.default_rng(3).standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex
    Sj, St = _both(d, K, border=ns)
    _, rj = Sj.apply_inverse(b)
    xt, rt = St.apply_inverse(b)
    assert rt.converged and rt.iters == int(rj.iters) > 8
    assert np.abs(St._border_coeffs - Sj._border_coeffs).max() <= 1e-10
    assert relres(K, xt.numpy(), b) < 1e-9


def test_the_iteration_cap_is_checked_between_cycles():
    """With 'Maximum Iterations' 20 and cycles of 8 both packages stop
    after the third cycle, unconverged at tolerance 1e-14."""
    K = laplace2d(32, 32).tocsr()
    d = _cfg("Left", "Zero", maxiter=20)
    d["Solver"]["Iterative Solver"]["Convergence Tolerance"] = 1e-14
    Sj, St = _both(d, K)
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    _, rj = Sj.apply_inverse(b)
    _, rt = St.apply_inverse(b)
    assert rt.iters == int(rj.iters) == 24
    assert not rt.converged and not bool(rj.converged)


@pytest.mark.parametrize("blocks", [100, 250])
def test_a_long_restart_is_full_gmres(blocks):
    K = laplace2d(32, 32).tocsr()
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    _, St = _both(_cfg(blocks=blocks), K)
    full = _cfg()
    del full["Solver"]["Iterative Solver"]["Num Blocks"]
    _, Sf = _both(full, K)
    xt, rt = St.apply_inverse(b)
    xf, rf = Sf.apply_inverse(b)
    assert rt.iters == rf.iters and torch.equal(xt, xf)


@pytest.mark.parametrize("scale_with_rhs", [False, True])
def test_gmres_function_restart_matches_reference(scale_with_rhs):
    """`krylov.gmres(restart=)` alone, unpreconditioned, from a nonzero
    start: the cycles inherit the solve's scale."""
    rng = np.random.default_rng(0)
    n = 60
    A = np.eye(n) * 4 + rng.standard_normal((n, n)) / np.sqrt(n)
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    At = torch.as_tensor(A)
    rt = krylov.gmres(lambda v: At @ v, torch.as_tensor(b),
                      torch.as_tensor(x0), tol=1e-10, maxiter=60, restart=5,
                      scale_with_rhs=scale_with_rhs)
    Aj = jnp.asarray(A)
    rj = jkrylov.gmres(lambda v: Aj @ v, jnp.asarray(b), jnp.asarray(x0),
                       tol=1e-10, maxiter=60, restart=5,
                       scale_with_rhs=scale_with_rhs)
    assert rt.converged and rt.iters == int(rj.iters) > 5
    assert rel(rj.x, rt.x.numpy()) <= 1e-10


@pytest.mark.parametrize("blocks", [10, 60])
def test_refinement_solver_takes_any_num_blocks(blocks):
    """'Num Blocks' below the inner basis (64) no longer raises at
    construction; `newton_step` does not restart (the reference's fused
    loop does not either), `apply_inverse` restarts per pass (f32
    counts within 2, or 5% where the short cycles stagnate)."""
    K = cavity_jacobian(16, 16, re=1000.0).tocsr()
    d = {"Problem": {"Equations": "Stokes-C", "Dimension": 2, "nx": 16,
                     "ny": 16},
         "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                    "Left or Right Preconditioning": "Right",
                    "Iterative Solver": {"Maximum Iterations": 250,
                                         "Convergence Tolerance": 1e-10,
                                         "Num Blocks": blocks}},
         "Preconditioner": {"Separator Length": 4, "Number of Levels": 1}}
    tv = create_testvector(T.Params(d), K)
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    Sj = JIR(K, H.Params(d), testvector=tv).compute()
    St = TIR(K, T.Params(d), testvector=tv, device="cpu").compute()
    assert St.solver.restart == blocks and St.inner_maxiter == 64
    fn, dplans, extra, aplans = Sj.newton_step_fn()
    rj = fn(Sj.op64.vals, Sj.solver.op.vals, dplans, extra, aplans,
            jnp.asarray(b))
    rt = St.newton_step(St.op64.vals, St.solver.op.vals, b)
    assert rt.converged and abs(rt.iters - int(rj.iters)) <= 2
    assert relres(K, rt.x.numpy(), b) <= 1e-10
    xj, raj = Sj.apply_inverse(b)
    xt, rat = St.apply_inverse(b)
    assert rat.converged and bool(raj.converged)
    # f32 cycles of 10 stagnate and restart a dozen times: the two
    # packages' rounding may part by an iteration per few cycles
    assert abs(rat.iters - int(raj.iters)) <= max(2, 0.05 * int(raj.iters))
    assert relres(K, xt.numpy(), b) <= 1e-10
