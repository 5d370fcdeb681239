"""Complex solves with a real preconditioner.

Torch counterpart of hymls_tpu/solvers/complex_solver.py, the
behavioural equivalent of the reference's ComplexSolver / ComplexVector
/ ComplexOperator (reference src/HYMLS_ComplexSolver.cpp,
HYMLS_ComplexVector.cpp, HYMLS_ComplexOperator.cpp): systems (A + i B) z
= b, e.g. complex-shifted Jacobians A - sigma M inside eigenvalue
computations, are solved by GMRES in genuine complex arithmetic, while
the multilevel preconditioner (which is real) is applied separately to
the real and imaginary parts.

The GMRES of solvers/krylov.py is dtype-generic: complex vectors,
conjugated Gram-Schmidt and complex-safe Givens rotations. Under
'Distributed Apply' with a mesh the iteration runs owner-sharded
(parallel/dist.py): A and B each on their own exchange plan, the real
halo V-cycle on the real and imaginary parts.
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
from ..parallel.dist import make_distributed_solve
from ..parallel.halo_vcycle import UnshardableError
from ..parallel.mesh import get_mesh
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
        # 'Distributed Apply': the complex GMRES in the owner-sharded
        # halo layout over the active mesh (reference ComplexSolver over
        # distributed Epetra vectors, src/HYMLS_ComplexSolver.hpp);
        # without a mesh, or unshardable, the replicated apply (with a
        # warning), as in Solver
        self.distributed = slist.get("Distributed Apply", False)
        self._A = A.tocsr()
        self._B = None if B is None else B.tocsr()
        self._dist = None
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
        # the halo apply stacks the factors it was built with
        self._dist = None
        return self

    def _make_dist(self):
        """This rank's owner-sharded plans over the active mesh, or None
        with a warning (mirrors Solver._make_dist)."""
        if self._dist is not None:
            return self._dist
        mesh = get_mesh()
        if mesh is None or mesh.size < 2:
            warnings.warn("'Distributed Apply' requested but no device "
                          "mesh is active (parallel.set_mesh); using the "
                          "replicated apply")
            self.distributed = False
            return None
        try:
            self._dist = make_distributed_solve(self._A, self.precond, mesh)
        except UnshardableError as e:
            warnings.warn(f"'Distributed Apply' unavailable ({e}); "
                          "using the replicated apply")
            self.distributed = False
            return None
        self._dist_B = None if self._B is None else \
            self._dist.make_extra_matvec(self._B)
        return self._dist

    def _solve_dist(self, dist, b):
        """The complex GMRES in the owner layout (reference
        complex_solver.py:_build_dist): (A + iB) z by the two exchange
        matvecs on complex vectors, the real halo V-cycle on the real
        and imaginary parts; with a border the augmented layout of
        dist.make_aug, as in the real bordered solve.  Returns the
        result with the global z ([z; s] with a border)."""
        pvA = dist.prepare(self.opA.vals)
        pvB = None if self._B is None else self._dist_B[0](self.opB.vals)
        fac_st = dist.stack_factors(self.precond.factors.pruned)
        cd = self.dtype

        def mv(z):
            y = dist.matvec(pvA, z)
            if pvB is not None:
                y = y + 1j * self._dist_B[1](pvB, z)
            return y.to(cd)

        def vcycle(z):
            zr, zi = real_imag(z)
            return torch.complex(dist.precond(fac_st, zr),
                                 dist.precond(fac_st, zi)).to(cd)

        kw = dict(tol=self.tol, maxiter=self.maxiter, left=False,
                  allreduce=dist.allreduce)
        bz = dist.scatter(b)
        if self._border is None:
            res = krylov.gmres(mv, bz, torch.zeros_like(bz), vcycle, **kw)
            return res._replace(x=dist.gather(res.x))

        if "border" not in fac_st["levels"][0]:
            raise RuntimeError("the distributed bordered solve needs the "
                               "bordered factors")
        V, W, C = self._border
        m = V.shape[1]
        aug = dist.make_aug(m)
        V_l, W_l = aug.scatter_cols(V), aug.scatter_cols(W)
        bord = dist.app.apply_local_bordered

        def opz(z):
            x_l, s = aug.split(z)
            tau = dist.allreduce(W_l.T.conj() @ x_l) + C @ s
            return aug.join(mv(x_l) + V_l @ s, tau)

        def precz(z):
            x_l, s = aug.split(z)
            (xr, xi), (sr, si) = real_imag(x_l), real_imag(s)
            xr, sr = bord(xr, sr, fac_st)
            xi, si = bord(xi, si, fac_st)
            return aug.join(torch.complex(xr, xi).to(cd),
                            torch.complex(sr, si).to(cd))

        res = krylov.gmres(opz, aug.join(bz, bz.new_zeros(m)),
                           torch.zeros(bz.shape[0] + m, dtype=cd,
                                       device=bz.device), precz, **kw)
        return res._replace(x=torch.cat(aug.gather_aug(res.x)))

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
        apply_fn, fac = self.precond.apply_fn, self.precond.factors
        dist = self._make_dist() if self.distributed else None
        b = torch.as_tensor(b, device=self.device).to(self.dtype)
        if dist is not None:
            res = self._solve_dist(dist, b)
            return res.x[:self.opA.n], res
        pvA = self.opA.prepare(self.opA.vals)
        pvB = None if self.opB is None else self.opB.prepare(self.opB.vals)
        tol, maxiter = self.tol, self.maxiter

        if self._border is None:
            def op(z):
                return self._matvec(pvA, pvB, z)

            def prec(z):
                zr, zi = real_imag(z)
                return torch.complex(apply_fn(fac, zr),
                                     apply_fn(fac, zi)).to(self.dtype)

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
            xr, sr = bord_fn(fac, xr, sr)
            xi, si = bord_fn(fac, xi, si)
            return torch.cat([torch.complex(xr, xi),
                              torch.complex(sr, si)]).to(self.dtype)

        res = krylov.gmres(opz, bz, torch.zeros_like(bz), precz, tol=tol,
                           maxiter=maxiter, left=False)
        return res.x[:n], res
