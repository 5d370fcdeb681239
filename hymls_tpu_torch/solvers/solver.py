"""Solver facade: Krylov method + preconditioner.

Torch counterpart of the single-device path of
hymls_tpu/solvers/solver.py (reference src/HYMLS_Solver.cpp:34-48,
HYMLS_BaseSolver.cpp): the 'Solver' sublist selects the Krylov method
(CG, or GMRES for any other name), the preconditioning side, the start
vector and the GMRES restart length ('Num Blocks'); a border turns the
solve into GMRES on the bordered system, and `setup_deflation` turns
it into the deflated solve (with a border: deflation of the bordered
system).
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import scipy.sparse as sp

import torch

from ..config import Params
from ..core.preconditioner import Preconditioner
from ..ops.operators import product_operator, projected_operator
from ..ops.spmv import make_operator
from . import krylov
from . import deflation as _defl


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
        # "CG", or GMRES for any other name, as in the reference
        self.method = slist.get("Krylov Method", "GMRES")
        # 'Random', 'Previous', or zero for any other value, as in the
        # reference
        self.start_vec = slist.get("Initial Vector", "Zero")
        self.lor = slist.get("Left or Right Preconditioning", "Left")
        it = slist.sublist("Iterative Solver")
        self.maxiter = it.get("Maximum Iterations", 100)
        self.tol = it.get("Convergence Tolerance", 1e-6)
        # Belos 'Num Blocks': GMRES basis size (restart length)
        self.restart = it.get("Num Blocks", None)
        # 'Distributed Apply': the Krylov iteration over a device mesh.
        # There is no mesh here, so the first solve warns and takes the
        # replicated apply (`_make_dist`), as the reference does without
        # an active mesh.
        self.distributed = slist.get("Distributed Apply", False)
        self._last_result = None
        self._border = None
        self._border_coeffs = None
        self._deflation = None
        self._defl_aug = False
        self._opT = None
        self._K = K
        self._mass = None
        self._prev_x = None
        self._rng = np.random.default_rng(42)

    def set_matrix(self, K: sp.csr_matrix):
        """New values, same pattern (Newton-step reuse)."""
        K = K.tocsr()
        K.sum_duplicates()
        K.sort_indices()
        self.op.set_values(K.data)
        self._K = K
        if self._opT is not None:
            # keep the transpose operator (deflation) in step
            self._opT.set_values(K.T.tocsr().data)

    def set_mass_matrix(self, M: Optional[sp.spmatrix]):
        """Mass matrix for deflation and eigenvalue use (reference
        BaseSolver::SetMassMatrix): deflation then targets the dominant
        eigenmodes of P^{-1} M instead of P^{-1}."""
        self._mass = None if M is None else sp.csr_matrix(M)
        return self

    def _make_dist(self):
        """The distributed operator and apply over the active mesh:
        none is ever active here, so this warns, switches the option
        off and returns None (the replicated apply)."""
        warnings.warn("'Distributed Apply' requested but no device mesh "
                      "is active; using the replicated apply")
        self.distributed = False
        return None

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
        coefficients s are in `_border_coeffs` (numpy).  After
        `setup_deflation` it is the deflated solve (zero start vector,
        zero border right-hand side), and the result is that of its
        projected solve."""
        if self._deflation is not None:
            bz = torch.as_tensor(b).cpu().numpy() if torch.is_tensor(b) \
                else np.asarray(b)
            if self._defl_aug:
                bz = np.concatenate([bz, np.zeros(self._border[0].shape[1])])
            x = _defl.deflated_apply(self._deflation, bz, self._proj_solve)
            return torch.as_tensor(x[:self.op.n], dtype=self.dtype,
                                   device=self.device), self._last_res
        if self.distributed:
            self._make_dist()
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

    # -- deflation ---------------------------------------------------------
    def setup_deflation(self, V: Optional[np.ndarray] = None):
        """Compute the deflation space and correction system (reference
        DeflatedSolver::SetupDeflation; parameter 'Deflated Subspace
        Dimension' in the 'Solver' list).  With a border set, deflation
        runs on the augmented system (the BorderedDeflatedSolver
        combination).  A dimension of 0 leaves the solver as it is.
        `V`, an orthonormal (n, k) block ((n + m, k) with a border),
        takes the place of the subspace iteration's result: the
        correction system is exact for any orthonormal V."""
        k = self.params.sublist("Solver").get(
            "Deflated Subspace Dimension", 0)
        if k <= 0:
            return self
        apply_fn, factors, dplans = self.precond.apply_inverse_fn()
        self._opT = make_operator(self._K.T.tocsr(), dtype=self.dtype,
                                  device=self.device)
        n = self.op.n
        aug = self._border is not None
        m = self._border[0].shape[1] if aug else 0

        # K and K' block products on the host (scipy); a column or an
        # (n, k) block both work
        Knp = self._K.tocsr()
        if not aug:
            def mv(z):
                return Knp @ np.asarray(z)

            def mvT(z):
                return Knp.T @ np.asarray(z)
        else:
            V_b, W_b, C_b = (a.cpu().numpy() for a in self._border)

            def mv(z):
                z = np.asarray(z)
                zx, zs = z[:n], z[n:]
                return np.concatenate([Knp @ zx + V_b @ zs,
                                       W_b.T @ zx + C_b @ zs])

            def mvT(z):
                z = np.asarray(z)
                zx, zs = z[:n], z[n:]
                return np.concatenate([Knp.T @ zx + W_b @ zs,
                                       V_b.T @ zx + C_b.T @ zs])

        # one column of the subspace iteration: the preconditioner
        # apply, with the mass operator in front of it
        Mop = None
        if self._mass is not None:
            Mop = make_operator(self._mass.tocsr(), dtype=self.dtype,
                                device=self.device)
        if not aug:
            def vcycle(z):
                return apply_fn(factors, dplans, z)
            apply_col = vcycle if Mop is None else \
                product_operator(vcycle, Mop)
        else:
            def apply_col(z):
                zx, zs = z[:n], z[n:]
                if Mop is not None:
                    zx = Mop(zx)
                return torch.cat(self.precond.apply_bordered_fn(
                    factors, dplans, zx, zs))

        self._defl_info = {}
        if V is None:
            V = _defl.compute_deflation_space_device(
                apply_col, n + m, k, self.dtype, device=self.device,
                _info=self._defl_info)
        Vt = torch.as_tensor(V, dtype=self.dtype, device=self.device)
        solve = self._build_proj_solve(aug)

        def proj_solve(r):
            res = solve(factors, dplans, Vt, torch.as_tensor(
                r, dtype=self.dtype, device=self.device))
            self._last_res = res
            return res.x.cpu().numpy()

        def multi_solve(Rhs):
            """The k projected setup columns, one solve each; the
            result kept is the last column's."""
            return np.column_stack([proj_solve(Rhs[:, j])
                                    for j in range(Rhs.shape[1])])

        self._deflation = _defl.setup_deflation(V, mv, mvT, proj_solve,
                                                multi_solve=multi_solve)
        self._proj_solve = proj_solve
        self._defl_aug = aug
        return self

    def _build_proj_solve(self, aug: bool = False):
        """solve(factors, dplans, V, b): GMRES from a zero start vector
        on the projected system (I - VV') A (I - VV'), preconditioned
        by the projected V-cycle; with `aug` on the bordered system."""
        tol, maxiter = self.tol, self.maxiter
        left = self.lor == "Left"
        n = self.op.n
        if self.distributed and not aug:
            self._make_dist()

        def run(op, prec, b):
            return krylov.gmres(op, b, torch.zeros_like(b), prec, tol=tol,
                                maxiter=maxiter, left=left)

        if not aug:
            apply_fn = self.precond.apply_fn

            def solve(factors, dplans, V, b):
                pvals = self.op.prepare(self.op.vals)
                return run(
                    projected_operator(
                        lambda x: self.op.matvec_prepared(pvals, x), V),
                    projected_operator(
                        lambda x: apply_fn(factors, dplans, x), V), b)
            return solve

        bord_fn = self.precond.apply_bordered_fn

        def solve(factors, dplans, V, b):
            Vb, Wb, Cb = self._border
            pvals = self.op.prepare(self.op.vals)

            def op(z):
                x, sb = z[:n], z[n:]
                return torch.cat([
                    self.op.matvec_prepared(pvals, x) + Vb @ sb,
                    Wb.T @ x + Cb @ sb])

            def prec(z):
                return torch.cat(bord_fn(factors, dplans, z[:n], z[n:]))

            return run(projected_operator(op, V),
                       projected_operator(prec, V), b)
        return solve

    @property
    def num_iter(self) -> int:
        return 0 if self._last_result is None else self._last_result.iters
