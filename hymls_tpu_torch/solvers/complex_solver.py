"""Complex solves with a real preconditioner.

Torch counterpart of the replicated parts of
hymls_tpu/solvers/complex_solver.py, the behavioural equivalent of the
reference's ComplexSolver / ComplexVector / ComplexOperator
(reference src/HYMLS_ComplexSolver.cpp, HYMLS_ComplexVector.cpp,
HYMLS_ComplexOperator.cpp): systems (A + i B) z = b, e.g.
complex-shifted Jacobians A - sigma M inside eigenvalue computations,
are solved by GMRES in genuine complex arithmetic, while the multilevel
preconditioner (which is real) is applied separately to the real and
imaginary parts.

The GMRES of solvers/krylov.py is dtype-generic: complex vectors,
conjugated Gram-Schmidt and complex-safe Givens rotations.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import scipy.sparse as sp

import torch

from ..config import Params
from ..core.preconditioner import Preconditioner
from ..ops.spmv import EllOperator
from . import krylov


def real_imag(z):
    """The real and imaginary parts of a complex tensor as contiguous
    tensors (`z.real` and `z.imag` are views with stride 2, which the
    DIA kernel's wrapper refuses)."""
    return z.real.contiguous(), z.imag.contiguous()


class ComplexSolver:
    """GMRES for (A + iB) z = b, right-preconditioned by the real
    multilevel preconditioner of A (applied to Re/Im separately)."""

    def __init__(self, A: sp.csr_matrix, precond: Preconditioner,
                 params: Params, B: Optional[sp.csr_matrix] = None,
                 dtype=torch.complex128, *, device):
        self.params = params
        self.precond = precond
        self.dtype = dtype
        self.device = torch.device(device)
        if precond.device != self.device:
            raise ValueError(f"preconditioner on {precond.device}, "
                             f"solver on {self.device}")
        self.rdtype = torch.float64 if dtype == torch.complex128 \
            else torch.float32
        # ELL, as in the JAX package: the products keep its summation
        # order
        self.opA = EllOperator(A, dtype=self.rdtype, device=self.device)
        self.opB = None if B is None else EllOperator(
            B, dtype=self.rdtype, device=self.device)

        slist = params.sublist("Solver")
        it = slist.sublist("Iterative Solver")
        self.maxiter = it.get("Maximum Iterations", 100)
        self.tol = it.get("Convergence Tolerance", 1e-8)
        # 'Distributed Apply': see Solver; there is no mesh here, so the
        # first solve warns and takes the replicated apply
        self.distributed = slist.get("Distributed Apply", False)
        self._border = None

    def set_border(self, V, W=None, C=None):
        """Bordered complex solve [A+iB V; W' C][z;s]=[b;0] (reference
        ComplexBorderedSolver; V/W/C real or complex).  The
        preconditioner is bordered with their real parts."""
        self.precond.set_border(np.real(V) if np.iscomplexobj(V) else V,
                                None if W is None else np.real(W),
                                None if C is None else np.real(C))
        V = np.asarray(V)
        if V.ndim == 1:
            V = V[:, None]
        W = V if W is None else np.asarray(W)
        if W.ndim == 1:
            W = W[:, None]
        m = V.shape[1]
        C = np.zeros((m, m)) if C is None else np.asarray(C)
        # in the complex dtype: `@` does not promote a real matrix
        # against a complex vector
        self._border = tuple(torch.as_tensor(a, device=self.device)
                             .to(self.dtype) for a in (V, W, C))
        return self

    def _make_dist(self):
        """No mesh is ever active here: warn, switch the option off and
        take the replicated apply (mirrors Solver._make_dist)."""
        warnings.warn("'Distributed Apply' requested but no device mesh "
                      "is active; using the replicated apply")
        self.distributed = False
        return None

    def _matvec(self, pvA, pvB, x):
        """(A + iB) x on the prepared values."""
        xr, xi = real_imag(x)
        yr = self.opA.matvec_prepared(pvA, xr)
        yi = self.opA.matvec_prepared(pvA, xi)
        if pvB is not None:
            yr = yr - self.opB.matvec_prepared(pvB, xi)
            yi = yi + self.opB.matvec_prepared(pvB, xr)
        return torch.complex(yr, yi).to(self.dtype)

    def apply_inverse(self, b):
        """Solve (A + iB) z = b, or with a border set the bordered
        system with a zero border right-hand side; returns
        (z, KrylovResult)."""
        apply_fn, factors, dplans = self.precond.apply_inverse_fn()
        if self.distributed:
            self._make_dist()
        b = torch.as_tensor(b, device=self.device).to(self.dtype)
        pvA = self.opA.prepare(self.opA.vals)
        pvB = None if self.opB is None else self.opB.prepare(self.opB.vals)
        tol, maxiter = self.tol, self.maxiter

        if self._border is None:
            def op(z):
                return self._matvec(pvA, pvB, z)

            def prec(z):
                zr, zi = real_imag(z)
                return torch.complex(
                    apply_fn(factors, dplans, zr),
                    apply_fn(factors, dplans, zi)).to(self.dtype)

            res = krylov.gmres(op, b, torch.zeros_like(b), prec, tol=tol,
                               maxiter=maxiter, left=False)
            return res.x, res

        bord_fn = self.precond.apply_bordered_fn
        n = self.opA.n
        V, W, C = self._border
        bz = torch.cat([b, b.new_zeros(V.shape[1])])

        def opz(z):
            x, s = z[:n], z[n:]
            return torch.cat([self._matvec(pvA, pvB, x) + V @ s,
                              W.T.conj() @ x + C @ s])

        def precz(z):
            (xr, xi), (sr, si) = real_imag(z[:n]), real_imag(z[n:])
            xr, sr = bord_fn(factors, dplans, xr, sr)
            xi, si = bord_fn(factors, dplans, xi, si)
            return torch.cat([torch.complex(xr, xi),
                              torch.complex(sr, si)]).to(self.dtype)

        res = krylov.gmres(opz, bz, torch.zeros_like(bz), precz, tol=tol,
                           maxiter=maxiter, left=False)
        return res.x[:n], res
