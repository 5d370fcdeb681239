"""Newton and pseudo-arclength continuation on top of the multilevel
solver.

Torch counterpart of hymls_tpu/nonlinear.py (the reference's NOX/LOCA
integration: HYMLS::Solver inside Newton steps, with a border carrying
the parameter derivative and the tangent for pseudo-arclength
continuation).  The residual, Jacobian and parameter derivative are
callables on numpy arrays on the host; the linear solves run on the
preconditioner's and solver's `device`.  The Jacobian keeps a fixed
sparsity pattern, so the preconditioner is re-factored by value only.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from .config import Params
from .core.preconditioner import Preconditioner
from .solvers.solver import Solver


@dataclass
class NewtonResult:
    x: np.ndarray
    iterations: int
    converged: bool
    residual_norms: List[float] = field(default_factory=list)


class NewtonSolver:
    """Newton's method with the multilevel preconditioner rebuilt by
    value each step."""

    def __init__(self, residual: Callable, jacobian: Callable,
                 params: Params, testvector=None,
                 tol: float = 1e-10, max_iter: int = 20, *, device):
        self.residual = residual
        self.jacobian = jacobian
        self.params = params
        self.testvector = testvector
        self.tol = tol
        self.max_iter = max_iter
        self.device = device
        self._P: Optional[Preconditioner] = None
        self._S: Optional[Solver] = None

    def _linear(self, J):
        if self._P is None:
            self._P = Preconditioner(J, self.params,
                                     testvector=self.testvector,
                                     device=self.device)
            self._S = Solver(J, self._P, self.params, device=self.device)
        self._P.compute(J)
        self._S.set_matrix(J)
        return self._S

    def solve(self, x0: np.ndarray) -> NewtonResult:
        x = np.asarray(x0, dtype=np.float64).copy()
        norms: List[float] = []
        for it in range(self.max_iter):
            F = np.asarray(self.residual(x))
            rn = float(np.linalg.norm(F))
            norms.append(rn)
            if rn < self.tol:
                return NewtonResult(x=x, iterations=it, converged=True,
                                    residual_norms=norms)
            S = self._linear(self.jacobian(x))
            dx, _res = S.apply_inverse(-F)
            # the step's one device-to-host copy: the residual is numpy
            x = x + dx.cpu().numpy()
        F = np.asarray(self.residual(x))
        norms.append(float(np.linalg.norm(F)))
        return NewtonResult(x=x, iterations=self.max_iter,
                            converged=norms[-1] < self.tol,
                            residual_norms=norms)


@dataclass
class ContinuationPoint:
    x: np.ndarray
    lam: float
    newton_iters: int


class Continuation:
    """Pseudo-arclength continuation of F(x, lam) = 0.

    Each corrector step solves the bordered Newton system
        [ J      F_lam ] [dx  ]   [ -F ]
        [ xdot'  ldot  ] [dlam] = [ -g ]
    with the bordered solver, which keeps the system nonsingular
    through folds."""

    def __init__(self, residual: Callable, jacobian: Callable,
                 dres_dlam: Callable, params: Params, testvector=None,
                 newton_tol: float = 1e-9, max_newton: int = 12, *,
                 device):
        self.residual = residual      # (x, lam) -> F
        self.jacobian = jacobian      # (x, lam) -> csr (fixed pattern)
        self.dres_dlam = dres_dlam    # (x, lam) -> dF/dlam
        self.params = params
        self.testvector = testvector
        self.newton_tol = newton_tol
        self.max_newton = max_newton
        self.device = device
        self._P: Optional[Preconditioner] = None
        self._S: Optional[Solver] = None

    def _bordered_solve(self, J, Flam, xdot, ldot, rhs_x, rhs_t):
        if self._P is None:
            self._P = Preconditioner(J, self.params,
                                     testvector=self.testvector,
                                     device=self.device)
            self._S = Solver(J, self._P, self.params, device=self.device)
        self._S.set_border(Flam, W=xdot, C=np.array([[ldot]]))
        self._P.compute(J)
        self._S.set_matrix(J)
        dx, _ = self._S.apply_inverse(rhs_x, t=np.array([rhs_t]))
        dlam = float(self._S._border_coeffs[0])
        # one device-to-host copy of dx per corrector (the Solver copied
        # the border coefficient already): the callables are numpy
        return dx.cpu().numpy(), dlam

    @staticmethod
    def save_state(path: str, x, lam, xdot, ldot, step: int, ds: float):
        """Write a restart checkpoint (atomic rename), the role of the
        reference rev-test continuation driver's 'Restart File' and
        backup interval."""
        tmp = f"{path}.tmp"
        np.savez(tmp, x=np.asarray(x), lam=float(lam),
                 xdot=np.asarray(xdot), ldot=float(ldot),
                 step=int(step), ds=float(ds))
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)

    @staticmethod
    def load_state(path: str) -> dict:
        """Read a restart checkpoint written by `save_state`."""
        with np.load(path) as z:
            return {k: (z[k].item() if z[k].ndim == 0 else z[k].copy())
                    for k in z.files}

    def trace(self, x0: np.ndarray, lam0: float, ds: float,
              n_steps: int, restart_file: Optional[str] = None,
              backup_interval: int = 0) -> List[ContinuationPoint]:
        """Trace the solution branch from (x0, lam0) with arclength
        steps of size ds (x0 must satisfy F(x0, lam0) ~ 0).

        With `restart_file` set, the tracer resumes from that checkpoint
        when it exists (completing the remaining steps of `n_steps`)
        and, when `backup_interval` > 0, rewrites it every
        `backup_interval` accepted steps and at the end."""
        start_step = 0
        if restart_file and os.path.exists(restart_file):
            st = self.load_state(restart_file)
            x = np.asarray(st["x"], np.float64).copy()
            lam = float(st["lam"])
            xdot = np.asarray(st["xdot"], np.float64).copy()
            ldot = float(st["ldot"])
            start_step = int(st["step"])
            branch = [ContinuationPoint(x=x.copy(), lam=lam,
                                        newton_iters=0)]
        else:
            x = np.asarray(x0, np.float64).copy()
            lam = float(lam0)
            branch = [ContinuationPoint(x=x.copy(), lam=lam,
                                        newton_iters=0)]

            # initial tangent: (dx/ds, dlam/ds) from J dx + F_lam dlam = 0
            J = self.jacobian(x, lam)
            Flam = np.asarray(self.dres_dlam(x, lam))
            dx, _ = self._bordered_solve(J, Flam, np.zeros_like(x), 1.0,
                                         np.zeros_like(x), 1.0)
            xdot = dx
            ldot = 1.0
            nrm = np.sqrt(np.dot(xdot, xdot) + ldot * ldot)
            xdot /= nrm
            ldot /= nrm

        for step in range(start_step, n_steps):
            # predictor
            xi = x + ds * xdot
            lami = lam + ds * ldot

            it = 0
            for it in range(1, self.max_newton + 1):
                F = np.asarray(self.residual(xi, lami))
                g = np.dot(xdot, xi - x) + ldot * (lami - lam) - ds
                if np.linalg.norm(F) < self.newton_tol and \
                        abs(g) < self.newton_tol:
                    break
                J = self.jacobian(xi, lami)
                Flam = np.asarray(self.dres_dlam(xi, lami))
                dxi, dlami = self._bordered_solve(J, Flam, xdot, ldot,
                                                  -F, -g)
                xi = xi + dxi
                lami = lami + dlami

            # new tangent (secant)
            tx = xi - x
            tl = lami - lam
            nrm = np.sqrt(np.dot(tx, tx) + tl * tl)
            xdot, ldot = tx / nrm, tl / nrm
            x, lam = xi, lami
            branch.append(ContinuationPoint(x=x.copy(), lam=lam,
                                            newton_iters=it))
            if restart_file and backup_interval > 0 and \
                    (step + 1) % backup_interval == 0:
                self.save_state(restart_file, x, lam, xdot, ldot,
                                step + 1, ds)
        if restart_file and backup_interval > 0:
            self.save_state(restart_file, x, lam, xdot, ldot, n_steps, ds)
        return branch
