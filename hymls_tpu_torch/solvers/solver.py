"""Solver facade: Krylov method + preconditioner.

Torch counterpart of the single-device path of
hymls_tpu/solvers/solver.py (reference src/HYMLS_Solver.cpp:34-48,
HYMLS_BaseSolver.cpp): the 'Solver' sublist selects the Krylov method
(GMRES or CG), the preconditioning side and the start vector.
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
        self.start_vec = slist.get("Initial Vector", "Zero")
        if self.start_vec not in ("Zero", "Random"):
            raise _unsupported(f"'Initial Vector' = {self.start_vec!r}",
                               "M5")
        self.lor = slist.get("Left or Right Preconditioning", "Left")
        it = slist.sublist("Iterative Solver")
        self.maxiter = it.get("Maximum Iterations", 100)
        self.tol = it.get("Convergence Tolerance", 1e-6)
        restart = it.get("Num Blocks", None)
        if restart is not None and restart < self.maxiter:
            raise _unsupported("restarted GMRES ('Num Blocks')", "M5")
        if slist.get("Distributed Apply", False):
            raise _unsupported("'Distributed Apply'", "M12")
        if slist.get("Deflated Subspace Dimension", 0) > 0:
            raise _unsupported("deflation", "M10")
        self._last_result = None
        self._rng = np.random.default_rng(42)

    def set_matrix(self, K: sp.csr_matrix):
        """New values, same pattern (Newton-step reuse)."""
        K = K.tocsr()
        K.sum_duplicates()
        K.sort_indices()
        self.op.set_values(K.data)

    def set_border(self, V, W=None, C=None):
        raise _unsupported("the bordered solver", "M9")

    def apply_inverse(self, b, x0: Optional[np.ndarray] = None):
        """Solve K x = b; returns (x, KrylovResult)."""
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        if x0 is None:
            if self.start_vec == "Random":
                x0 = self._rng.standard_normal(b.shape[0])
            else:
                x0 = np.zeros(b.shape[0])
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device)
        pvals = self.op.prepare(self.op.vals)
        factors = self.precond.apply_factors
        dplans = self.precond._aplans

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
                               left=self.lor == "Left")
        self._last_result = res
        return res.x, res

    @property
    def num_iter(self) -> int:
        return 0 if self._last_result is None else self._last_result.iters
