"""Solver facade: Krylov method + preconditioner.

Torch counterpart of the single-device path of
hymls_tpu/solvers/solver.py (reference src/HYMLS_Solver.cpp:34-48,
HYMLS_BaseSolver.cpp): the 'Solver' sublist selects the Krylov method
(GMRES or CG), the preconditioning side, the start vector and the
GMRES restart length ('Num Blocks'); a border turns the solve into
GMRES on the bordered system.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

import torch

from ..config import Params
from ..core.preconditioner import Preconditioner, _unsupported
from ..ops.spmv import make_operator
from . import krylov


class Solver:
    """Iterative solve of K x = b with the multilevel preconditioner."""

    def __init__(self, K: sp.csr_matrix, precond: Preconditioner,
                 params: Params, dtype=torch.float64, *, device):
        self.params = params
        self.precond = precond
        self.dtype = dtype
        self.device = torch.device(device)
        if precond.device != self.device:
            raise ValueError(f"preconditioner on {precond.device}, "
                             f"solver on {self.device}")
        self.op = make_operator(K, dtype=dtype, device=self.device)

        slist = params.sublist("Solver")
        self.method = slist.get("Krylov Method", "GMRES")
        if self.method not in ("GMRES", "CG"):
            raise _unsupported(f"'Krylov Method' = {self.method!r}", "M10")
        # 'Random', 'Previous', or zero for any other value, as in the
        # reference
        self.start_vec = slist.get("Initial Vector", "Zero")
        self.lor = slist.get("Left or Right Preconditioning", "Left")
        it = slist.sublist("Iterative Solver")
        self.maxiter = it.get("Maximum Iterations", 100)
        self.tol = it.get("Convergence Tolerance", 1e-6)
        # Belos 'Num Blocks': GMRES basis size (restart length)
        self.restart = it.get("Num Blocks", None)
        if slist.get("Distributed Apply", False):
            raise _unsupported("'Distributed Apply'", "M12")
        if slist.get("Deflated Subspace Dimension", 0) > 0:
            raise _unsupported("deflation", "M10")
        self._last_result = None
        self._border = None
        self._border_coeffs = None
        self._prev_x = None
        self._rng = np.random.default_rng(42)

    def set_matrix(self, K: sp.csr_matrix):
        """New values, same pattern (Newton-step reuse)."""
        K = K.tocsr()
        K.sum_duplicates()
        K.sort_indices()
        self.op.set_values(K.data)

    def set_border(self, V, W=None, C=None):
        """Solve the bordered system [K V; W' C] [x; s] = [b; t]
        (reference BorderedSolver; used to pin a null space such as the
        constant pressure mode, and by pseudo-arclength continuation).
        W=None means W = V, C=None means 0; V=None removes the
        border."""
        self.precond.set_border(V, W, C)
        border = self.precond._border
        self._border = None if border is None else tuple(
            a.to(self.dtype) for a in border)
        return self

    def _start_vector(self, b):
        if self.start_vec == "Random":
            return torch.as_tensor(self._rng.standard_normal(b.shape[0]),
                                   dtype=self.dtype, device=self.device)
        if self.start_vec == "Previous" and self._prev_x is not None \
                and self._prev_x.shape == b.shape:
            # reference BaseSolver start vector 'Previous': the last
            # solution (continuation runs)
            return self._prev_x.to(self.dtype)
        return torch.zeros_like(b)

    def apply_inverse(self, b, x0: Optional[np.ndarray] = None, t=None):
        """Solve K x = b, or with a border set the bordered system with
        border right-hand side `t` (zero by default); returns
        (x, KrylovResult).  After a bordered solve the border
        coefficients s are in `_border_coeffs` (numpy)."""
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        x0 = self._start_vector(b) if x0 is None else torch.as_tensor(
            x0, dtype=self.dtype, device=self.device)
        pvals = self.op.prepare(self.op.vals)
        factors = self.precond.apply_factors
        dplans = self.precond._aplans

        if self._border is not None:
            res = self._solve_bordered(pvals, factors, dplans, b, x0, t)
            n = self.op.n
            x = res.x[:n]
            self._border_coeffs = res.x[n:].cpu().numpy()
        else:
            def op(x):
                return self.op.matvec_prepared(pvals, x)

            def prec(x):
                return self.precond.apply_fn(factors, dplans, x)

            if self.method == "CG":
                res = krylov.cg(op, b, x0, prec, tol=self.tol,
                                maxiter=self.maxiter)
            else:
                res = krylov.gmres(op, b, x0, prec, tol=self.tol,
                                   maxiter=self.maxiter,
                                   left=self.lor == "Left",
                                   restart=self.restart)
            x = res.x
            self._border_coeffs = None
        self._last_result = res
        self._prev_x = x
        return x, res

    def _solve_bordered(self, pvals, factors, dplans, b, x0, t):
        """GMRES on the augmented system: the operator
        [K x + V s; W' x + C s], preconditioned by the bordered
        V-cycle."""
        V, W, C = self._border
        n, m = self.op.n, V.shape[1]
        if t is None:
            t = b.new_zeros(m)
        t = torch.as_tensor(t, dtype=self.dtype, device=self.device)

        def op(z):
            x, s = z[:n], z[n:]
            return torch.cat([self.op.matvec_prepared(pvals, x) + V @ s,
                              W.T @ x + C @ s])

        def prec(z):
            return torch.cat(self.precond.apply_bordered_fn(
                factors, dplans, z[:n], z[n:]))

        return krylov.gmres(op, torch.cat([b, t]),
                            torch.cat([x0, b.new_zeros(m)]), prec,
                            tol=self.tol, maxiter=self.maxiter,
                            left=self.lor == "Left", restart=self.restart)

    @property
    def num_iter(self) -> int:
        return 0 if self._last_result is None else self._last_result.iters
