"""Eigenvalue computation: Jacobi-Davidson QR with multilevel-
preconditioned correction equations, plus a shift-invert Arnoldi
fallback.

Torch counterpart of hymls_tpu/solvers/eigen.py, the behavioural
equivalent of the reference's eigensolver stack
(reference src/main_eigs.cpp, src/AnasaziPhistSolMgr.hpp, phist
subspacejada, and src/HYMLS_PhistCustomCorrectionSolver.cpp, which
solves the JD correction equations with the HYMLS preconditioner):
generalized eigenpairs of (K, M) nearest a target, with parameters
matching the reference's 'Eigenvalues' sublist ('How Many', 'Which',
'Convergence Tolerance', 'Maximum Subspace Dimension', 'Restart
Dimension', 'Number of Iterations').

The outer subspace loop runs on the host in numpy (it is inherently
sequential and tiny); every matvec with K and M and every projected
correction solve runs on tensors on the solver's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import torch

from ..config import Params
from ..core.preconditioner import Preconditioner
from ..ops.spmv import EllOperator
from . import krylov
from .complex_solver import real_imag


@dataclass
class EigenResult:
    values: np.ndarray
    vectors: np.ndarray
    iterations: int
    converged: int
    residuals: List[float] = field(default_factory=list)


def shift_invert_eigs(K: sp.csr_matrix, M: Optional[sp.csr_matrix],
                      solver, k: int = 10, target: float = 0.0,
                      tol: float = 1e-8) -> EigenResult:
    """ARPACK shift-invert around `target` on the host, with the inner
    solves done by the multilevel solver (the role Anasazi BKS +
    HYMLS::Solver play in the reference main_eigs non-PHIST path).
    `solver.apply_inverse` takes a numpy vector and returns (x, result)
    with x a tensor; numpy in and out."""
    n = K.shape[0]

    def opinv(b):
        x, _res = solver.apply_inverse(np.asarray(b, dtype=np.float64))
        return x.cpu().numpy()

    OPinv = spla.LinearOperator((n, n), matvec=opinv, dtype=np.float64)
    Mop = None if M is None else spla.aslinearoperator(M)
    vals, vecs = spla.eigs(spla.aslinearoperator(K), k=k, M=Mop,
                           sigma=target, OPinv=OPinv, tol=tol)
    order = np.argsort(np.abs(vals - target))
    return EigenResult(values=vals[order], vectors=vecs[:, order],
                       iterations=-1, converged=k)


class JDQR:
    """Jacobi-Davidson QR for (K, M) with preconditioned, projected
    correction equations (the role of phist subspacejada +
    PhistCustomCorrectionSolver in the reference main_eigs).

    Requires M nonsingular (or None): the search space is kept
    M-orthonormal, so ker(M) components are uncontrolled and a
    singular mass (e.g. the zero pressure block of a Stokes pencil)
    produces spurious Ritz values.  For such pencils use
    `shift_invert_eigs`, whose shift-invert operator purifies infinite
    modes automatically."""

    def __init__(self, K: sp.csr_matrix, M: Optional[sp.csr_matrix],
                 precond: Preconditioner, params: Params,
                 dtype=torch.float64, *, device):
        self.K = K
        self.M = M
        self.precond = precond
        self.dtype = dtype
        self.cdtype = torch.complex128 if dtype == torch.float64 \
            else torch.complex64
        self.device = torch.device(device)
        if precond.device != self.device:
            raise ValueError(f"preconditioner on {precond.device}, "
                             f"eigensolver on {self.device}")
        # ELL, as in the JAX package: the products keep its summation
        # order
        self.opK = EllOperator(K, dtype=dtype, device=self.device)
        self.opM = None if M is None else EllOperator(
            M, dtype=dtype, device=self.device)

        eig = params.sublist("Driver").sublist("Eigenvalues")
        self.how_many = eig.get("How Many", 10)
        self.which = eig.get("Which", "SM")
        self.tol = eig.get("Convergence Tolerance", 1e-8)
        self.max_iter = eig.get("Number of Iterations", 100)
        self.max_subspace = eig.get("Maximum Subspace Dimension", 40)
        self.restart_dim = eig.get("Restart Dimension", 20)
        self.inner_iters = eig.get("Correction Iterations", 10)
        self.target = eig.get("Target", 0.0)
        # 'Bordered Solver' (reference laplace2_eigs.xml): correction
        # preconditioning through the bordered hierarchy.  Off by
        # default: a nullspace border pins W'x = 0, which fights the
        # JD oblique projectors and stalls corrections (observed on
        # the Turing Jacobian); the reference's bordered correction
        # solver borders with the *projection space*, not the
        # nullspace (HYMLS_PhistCustomCorrectionSolver.cpp)
        self.use_bordered = eig.get("Bordered Solver", False)
        #: correction solves of each kind in the last `solve`
        self.corrections = {"real": 0, "pair": 0}

    def _on_device(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # -- the correction solves ---------------------------------------------
    def _build_corr(self):
        """(corr, corr_c): the real and the conjugate-pair correction
        solves, closed over the preconditioner's apply and factors."""
        p = self.precond
        apply_fn, fac = p.apply_fn, p.factors
        if p._border is not None:
            if self.use_bordered:
                # bordered preconditioner: apply [P V; W' C]^{-1} with
                # zero border rhs and keep the x part (reference
                # BorderedSolver convention for the correction
                # preconditioner)
                bord_fn = p.apply_bordered_fn
                mb = p._border[0].shape[1]

                def apply_fn(fac, x):                 # noqa: F811
                    return bord_fn(fac, x, x.new_zeros(mb))[0]
            else:
                # P was computed with a nullspace border, whose
                # augmented coarse factor the plain apply cannot
                # consume: refactor once without the border.  The
                # correction preconditioner is plain P^{-1}; nullspace
                # directions are handled by the JD oblique projectors
                # (reference HYMLS_PhistCustomCorrectionSolver.cpp
                # preconditions with the plain hierarchy)
                fac = p.factorize(p.K.data, border=None)
        opK, opM = self.opK, self.opM
        pvK = opK.prepare(opK.vals)
        pvM = None if opM is None else opM.prepare(opM.vals)
        inner = self.inner_iters
        self.corrections = {"real": 0, "pair": 0}

        def corr(Q, MQ, r, theta):
            """Solve the deflated correction equation
            (I-MQ Q')(K - theta M)(I-Q Q'M) t = -r with preconditioned
            GMRES.  Q: M-orthonormal basis (Q'MQ = I) of the locked
            vectors and the current Ritz vector; MQ = M @ Q.  For
            M = I this is the standard JDQR projection; for a pencil
            it is the proper oblique (partial generalized Schur)
            deflation, cf. the phist subspacejada deflation the
            reference uses (src/AnasaziPhistSolMgr.hpp:40-60)."""
            def proj_r(x):          # right: x - Q (Q'M x)
                return x - Q @ (MQ.T @ x)

            def proj_l(y):          # left: y - MQ (Q'y)
                return y - MQ @ (Q.T @ y)

            def op(x):
                x = proj_r(x)
                y = opK.matvec_prepared(pvK, x)
                if opM is not None:
                    y = y - theta * opM.matvec_prepared(pvM, x)
                else:
                    y = y - theta * x
                return proj_l(y)

            def prec(x):
                return proj_r(apply_fn(fac, proj_l(x)))

            self.corrections["real"] += 1
            return krylov.gmres(op, -r, torch.zeros_like(r), prec,
                                tol=1e-3, maxiter=inner).x

        def corr_c(Q, MQ, r, theta):
            """Complex-shifted correction equation for a conjugate
            Ritz pair: the same oblique projections with the real pair
            basis {Re u, Im u} in Q, complex arithmetic in the Krylov
            loop, the real preconditioner applied to Re/Im separately
            (the role of the reference's ComplexSolver inside
            HYMLS_PhistCustomCorrectionSolver.cpp)."""
            # `@` does not promote a real matrix against a complex vector
            Q, MQ = Q.to(r.dtype), MQ.to(r.dtype)

            def proj_r(x):
                return x - Q @ (MQ.T @ x)

            def proj_l(y):
                return y - MQ @ (Q.T @ y)

            def op(x):
                x = proj_r(x)
                xr, xi = real_imag(x)
                y = torch.complex(opK.matvec_prepared(pvK, xr),
                                  opK.matvec_prepared(pvK, xi))
                if opM is not None:
                    y = y - theta * torch.complex(
                        opM.matvec_prepared(pvM, xr),
                        opM.matvec_prepared(pvM, xi))
                else:
                    y = y - theta * x
                return proj_l(y)

            def prec(x):
                xr, xi = real_imag(proj_l(x))
                return proj_r(torch.complex(apply_fn(fac, xr),
                                            apply_fn(fac, xi)))

            self.corrections["pair"] += 1
            return krylov.gmres(op, -r, torch.zeros_like(r), prec,
                                tol=1e-3, maxiter=inner).x

        return corr, corr_c

    # -- the outer loop -----------------------------------------------------
    def solve(self, v0: Optional[np.ndarray] = None) -> EigenResult:
        n = self.K.shape[0]
        k_want = self.how_many
        max_lock = k_want + 2
        corr, corr_c = self._build_corr()

        def on_host(op):
            return lambda x: op(torch.as_tensor(
                x, dtype=self.dtype, device=self.device)).cpu().numpy()

        Kx = on_host(self.opK)
        Mx = on_host(self.opM) if self.opM is not None \
            else (lambda x: np.array(x, copy=True))

        locked_Q: List[np.ndarray] = []    # Q' M Q = I
        locked_MQ: List[np.ndarray] = []   # M @ Q columns
        locked_vals: List[float] = []
        res_hist: List[float] = []

        def m_orthonormalize(cols, Vs=None, MVs=None):
            """M-orthonormal basis (and its M-image) from the columns
            of `cols`, kept M-orthogonal to the locked vectors and to
            the optional existing basis Vs (CGS2)."""
            Vs = [] if Vs is None else list(Vs)
            MVs = [] if MVs is None else list(MVs)
            n0 = len(Vs)
            for j in range(cols.shape[1]):
                t = np.array(cols[:, j])
                for _ in range(2):
                    for q, mq in zip(locked_Q, locked_MQ):
                        t -= q * (mq @ t)
                    for q, mq in zip(Vs, MVs):
                        t -= q * (mq @ t)
                Mt = Mx(t)
                tn = float(np.sqrt(abs(t @ Mt)))
                if tn < 1e-10:
                    continue
                Vs.append(t / tn)
                MVs.append(Mt / tn)
            return Vs[n0:], MVs[n0:]

        rng = np.random.default_rng(31)
        # constant start vector (the reference main_eigs uses a
        # B-orthogonalized constant start, src/main_eigs.cpp) — it is
        # rich in the smooth low modes JD targets and saves ~15%
        # outer iterations vs a random start
        v = v0 if v0 is not None else np.ones(n)
        Vs, MVs = m_orthonormalize(np.asarray(v, float)[:, None])
        V = np.column_stack(Vs)
        MV = np.column_stack(MVs)
        KV = Kx(V[:, 0])[:, None]

        locked_vecs: List[np.ndarray] = []   # eigenvectors (complex
        #                                      for conjugate pairs)

        def refresh(Vp):
            """Re-orthonormalize a candidate basis after purging."""
            Vs, MVs = m_orthonormalize(Vp)
            if not Vs:
                Vs, MVs = m_orthonormalize(rng.standard_normal((n, 1)))
            Vn = np.column_stack(Vs)
            MVn = np.column_stack(MVs)
            KVn = np.column_stack([Kx(Vn[:, j])
                                   for j in range(Vn.shape[1])])
            return Vn, MVn, KVn

        it = 0
        while it < self.max_iter and len(locked_vals) < k_want:
            it += 1
            # V is M-orthonormal, so the projected pencil is (H, I)
            H = V.T @ KV
            w, Y = sla.eig(H)
            # select Ritz value: nearest target / smallest magnitude
            if self.which == "LM":
                order = np.argsort(-np.abs(w))
            elif self.which == "LR":
                order = np.argsort(-w.real)
            else:
                order = np.argsort(np.abs(w - self.target))
            wsel = w[order[0]]
            pair = abs(wsel.imag) > 1e-10 * max(1.0, abs(wsel))

            if pair:
                # conjugate Ritz pair: complex Ritz vector, complex
                # residual, complex-shifted correction (reference
                # HYMLS_PhistCustomCorrectionSolver.cpp)
                theta_c = complex(wsel)
                y_c = Y[:, order[0]]
                u_c = V @ y_c
                Mu_c = MV @ y_c
                un = float(np.sqrt(abs(np.vdot(u_c, Mu_c)))) or 1.0
                u_c /= un
                Mu_c /= un
                r = (Kx(u_c.real) + 1j * Kx(u_c.imag)) - theta_c * Mu_c
                # the M-orthonormal real basis of the pair subspace
                pQ, pMQ = m_orthonormalize(
                    np.column_stack([u_c.real, u_c.imag]))
            else:
                theta_c = complex(wsel.real)
                y = Y[:, order[0]].real
                y = y / np.linalg.norm(y)
                u = V @ y
                Mu = MV @ y
                un = float(np.sqrt(abs(u @ Mu))) or 1.0
                u /= un
                Mu /= un
                r = Kx(u) - theta_c.real * Mu
                pQ, pMQ = [u], [Mu]

            # oblique deflation of the locked pairs: r <- (I - MQ Q') r
            for q, mq in zip(locked_Q, locked_MQ):
                r = r - mq * (q @ r)
            rn = float(np.linalg.norm(r))
            res_hist.append(rn)

            if rn < self.tol:
                locked_Q.extend(pQ)
                locked_MQ.extend(pMQ)
                if pair:
                    locked_vals.extend([theta_c, np.conj(theta_c)])
                    locked_vecs.extend([u_c, np.conj(u_c)])
                else:
                    locked_vals.append(theta_c.real)
                    locked_vecs.append(u)
                # purge the locked directions, keep M-orthonormality
                Vp = V
                for q, mq in zip(pQ, pMQ):
                    Vp = Vp - q[:, None] * (mq @ Vp)[None, :]
                keep = max(V.shape[1] - len(pQ), 1)
                V, MV, KV = refresh(Vp)
                V, MV, KV = V[:, :keep], MV[:, :keep], KV[:, :keep]
                continue

            # correction equation, obliquely deflated against the
            # locked vectors (at most max_lock of them) and the current
            # (pair) Ritz space
            Q = self._on_device(np.column_stack(
                locked_Q[:max_lock] + pQ))
            MQ = self._on_device(np.column_stack(
                locked_MQ[:max_lock] + pMQ))
            if pair:
                t_c = corr_c(Q, MQ, torch.as_tensor(
                    r, dtype=self.cdtype, device=self.device),
                    theta_c).cpu().numpy()
                t_cols = np.column_stack([t_c.real, t_c.imag])
            else:
                t = corr(Q, MQ, self._on_device(r),
                         theta_c.real).cpu().numpy()
                t_cols = t[:, None]

            if V.shape[1] + t_cols.shape[1] > self.max_subspace:
                # restart with the best Ritz vectors
                idx = order[:self.restart_dim]
                V, MV, KV = refresh(V @ Y[:, idx].real)

            # expand with the M-orthonormalized correction direction(s)
            Vs, MVs = m_orthonormalize(t_cols, Vs=list(V.T),
                                       MVs=list(MV.T))
            if not Vs:
                Vs, MVs = m_orthonormalize(
                    rng.standard_normal((n, 1)), Vs=list(V.T),
                    MVs=list(MV.T))
            for vnew in Vs:
                KV = np.column_stack([KV, Kx(vnew)])
            V = np.column_stack([V] + Vs)
            MV = np.column_stack([MV] + MVs)

        anycomplex = any(abs(np.imag(v)) > 0 for v in locked_vals)
        vals = np.array(locked_vals)
        if not anycomplex:
            vals = vals.real
        vecs = np.column_stack(locked_vecs) if locked_vecs \
            else np.zeros((n, 0))
        return EigenResult(values=vals, vectors=vecs, iterations=it,
                           converged=len(locked_vals),
                           residuals=res_hist)
