"""The port's Newton and pseudo-arclength continuation
(hymls_tpu_torch/nonlinear.py) against the JAX package's, on the 2D
Bratu problem -lap(u) = lam * exp(u) of tests/test_nonlinear.py (fold
at lam* ~ 6.81):

  * `NewtonSolver` at 16^2: the reference's Newton iteration count, x
    within 1e-9;
  * the 6-step continuation at 8^2 and its restart from a checkpoint:
    every point's lam within 1e-8 of the reference's;
  * the trace through the fold at 16^2: the reference's own criteria
    (tests/test_nonlinear.py::test_continuation_through_fold), and lam
    per point within 1e-8 of the reference's.
"""
import numpy as np
import scipy.sparse as sp

import hymls_tpu.nonlinear as HN
import hymls_tpu_torch.nonlinear as TN
from hymls_tpu.config import Params as HParams
from hymls_tpu_torch.config import Params as TParams
from hymls_tpu_torch.stencils import laplace2d


def _bratu(nx):
    """tests/test_nonlinear.py:_bratu."""
    L = -laplace2d(nx, nx)
    h2 = 1.0 / (nx + 1) ** 2

    def residual(x, lam):
        return L @ x - lam * h2 * np.exp(x)

    def jacobian(x, lam):
        J = (L - sp.diags(lam * h2 * np.exp(x))).tocsr()
        J.sum_duplicates()
        J.sort_indices()
        return J

    def dres_dlam(x, lam):
        return -h2 * np.exp(x)

    return residual, jacobian, dres_dlam


def _cfg(nx):
    """tests/test_nonlinear.py:_params."""
    return {"Problem": {"Equations": "Laplace", "Dimension": 2,
                        "nx": nx, "ny": nx},
            "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                       "Iterative Solver": {"Maximum Iterations": 100,
                                            "Convergence Tolerance": 1e-12}},
            "Preconditioner": {"Separator Length": 4,
                               "Number of Levels": 1}}


def _newton(nx, lam, port):
    residual, jacobian, _ = _bratu(nx)
    args = (lambda x: residual(x, lam), lambda x: jacobian(x, lam))
    if port:
        ns = TN.NewtonSolver(*args, TParams(_cfg(nx)), device="cpu")
    else:
        ns = HN.NewtonSolver(*args, HParams(_cfg(nx)))
    return ns.solve(np.zeros(nx * nx))


def _continuation(nx, port):
    residual, jacobian, dlam = _bratu(nx)
    if port:
        return TN.Continuation(residual, jacobian, dlam, TParams(_cfg(nx)),
                               device="cpu")
    return HN.Continuation(residual, jacobian, dlam, HParams(_cfg(nx)))


def test_newton_bratu_matches_reference():
    ref = _newton(16, 3.0, port=False)
    got = _newton(16, 3.0, port=True)
    residual, _, _ = _bratu(16)
    assert got.converged and got.iterations == ref.iterations <= 8
    assert np.abs(got.x - ref.x).max() <= 1e-9
    assert np.linalg.norm(residual(got.x, 3.0)) < 1e-10
    assert got.x.max() > 0.1
    assert len(got.residual_norms) == len(ref.residual_norms)


def test_continuation_and_restart_match_reference(tmp_path):
    nx = 8
    start = _newton(nx, 0.5, port=True)
    assert start.converged
    ref = _continuation(nx, port=False).trace(start.x, 0.5, ds=1.0,
                                              n_steps=6)
    full = _continuation(nx, port=True).trace(start.x, 0.5, ds=1.0,
                                              n_steps=6)
    assert len(full) == len(ref) == 7
    for p, q in zip(full, ref):
        assert abs(p.lam - q.lam) <= 1e-8
        assert p.newton_iters == q.newton_iters

    ckpt = str(tmp_path / "restart.npz")
    _continuation(nx, port=True).trace(start.x, 0.5, ds=1.0, n_steps=3,
                                       restart_file=ckpt, backup_interval=1)
    assert TN.Continuation.load_state(ckpt)["step"] == 3
    resumed = _continuation(nx, port=True).trace(
        start.x, 0.5, ds=1.0, n_steps=6, restart_file=ckpt,
        backup_interval=2)
    assert len(resumed) == 4
    for p, q in zip(resumed[1:], ref[4:]):
        assert abs(p.lam - q.lam) <= 1e-8
    assert np.linalg.norm(resumed[-1].x - full[-1].x) < 1e-7
    assert TN.Continuation.load_state(ckpt)["step"] == 6


def test_continuation_through_fold_matches_reference():
    nx = 16
    start = _newton(nx, 0.5, port=True)
    ref = _continuation(nx, port=False).trace(start.x, 0.5, ds=1.0,
                                              n_steps=22)
    branch = _continuation(nx, port=True).trace(start.x, 0.5, ds=1.0,
                                                n_steps=22)
    lams = [p.lam for p in branch]
    umax = [p.x.max() for p in branch]
    assert max(lams) > 6.0
    assert lams[-1] < max(lams) - 0.3, f"did not turn: {lams}"
    assert umax[-1] > umax[lams.index(max(lams))]
    assert all(p.newton_iters < 12 for p in branch)
    for p, q in zip(branch, ref):
        assert abs(p.lam - q.lam) <= 1e-8
