"""Deflated solves: remove slow eigenmodes of the preconditioned
operator from the Krylov iteration.

Torch counterpart of hymls_tpu/solvers/deflation.py, the behavioural
equivalent of the reference's DeflatedSolver
(reference src/HYMLS_DeflatedSolver.cpp): the dominant eigenvectors of
P^{-1} (or P^{-1}M with a mass matrix) span the modes the
preconditioner handles worst; they are computed once per Compute, and
every solve then runs the projected system

    (I - VV')A(I - VV') y = (I - VV') b

plus a small dense correction system for the V-components
(reference SetupDeflation lines 87-157 / ApplyInverse 159-245).

The deflation space and the correction system live on the host as
numpy arrays, as in the JAX package; only the block applies of the
subspace iteration and the projected solves run on tensors.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.sparse.linalg as spla

import torch


class Deflation:
    """Holds the deflation space and dense correction factors."""

    def __init__(self, V, AV, ATV, R, D):
        self.V = V                 # (n, k) orthonormal deflation space
        self.AV = AV               # K @ V
        self.ATV = ATV             # K' @ V
        self.R = R                 # solve of projected AV ("deflationRhs")
        self.D = D                 # dense correction matrix (k, k)
        self.D_inv = np.linalg.inv(D)

    @property
    def k(self):
        return self.V.shape[1]


def _realify(vecs: np.ndarray) -> np.ndarray:
    """Real columns spanning the (possibly complex-pair) vectors: the
    real part of each, and its imaginary part where that is nonzero."""
    cols = []
    for j in range(vecs.shape[1]):
        cols.append(np.real(vecs[:, j]))
        if np.any(np.imag(vecs[:, j]) != 0):
            cols.append(np.imag(vecs[:, j]))
    return np.column_stack(cols)


def compute_deflation_space(apply_prec: Callable, n: int, num_eigs: int,
                            apply_mass: Optional[Callable] = None,
                            tol: float = 1e-8) -> np.ndarray:
    """Dominant eigenspace of P^{-1} (resp. P^{-1} M) as a real
    orthonormal basis, by ARPACK on the host (reference EigsPrec + SVQB
    normalize).  `apply_prec` and `apply_mass` take and return numpy
    vectors."""

    def mv(x):
        x = np.asarray(x, dtype=np.float64)
        if apply_mass is not None:
            x = np.asarray(apply_mass(x))
        return np.asarray(apply_prec(x))

    op = spla.LinearOperator((n, n), matvec=mv, dtype=np.float64)
    k = min(num_eigs, n - 2)
    _vals, vecs = spla.eigs(op, k=k, which="LM", tol=tol)
    Q, _ = np.linalg.qr(_realify(vecs))
    return Q[:, :num_eigs]


def compute_deflation_space_device(apply_col: Callable, n: int,
                                   num_eigs: int, dtype, *, device,
                                   iters: int = 60, oversample: int = 6,
                                   seed: int = 12345,
                                   rtol: Optional[float] = None,
                                   _info: Optional[dict] = None
                                   ) -> np.ndarray:
    """Dominant eigenspace of P^{-1}(M) by blocked subspace iteration
    with a Rayleigh-Ritz extraction.

    The loop is residual-gated (the reference's Anasazi BKS iterates to
    a convergence tolerance, src/HYMLS_DeflatedSolver.cpp:247-310, not
    a fixed count): each iteration measures the block-invariance
    residual ||Z - Q(Q'Z)||_F / ||Q'Z||_F over the leading `num_eigs`
    columns (subspace iteration orders columns by descending |lambda|)
    and stops when it drops under `rtol`, or after `iters` iterations.
    The deflation algebra is exact for any orthonormal V (R and D are
    recomputed from V), so rtol only controls how well V spans the slow
    modes.

    `apply_col` maps an (n,) tensor to an (n,) tensor (the
    preconditioner apply, optionally composed with the mass operator);
    a block apply is a Python loop over the block's columns, and each
    iteration reads its residual on the host once.  The start block is
    drawn and orthonormalized on the host, so that it is the JAX
    package's.  `_info`, when a dict, receives {'applies', 'rel'}."""
    kp = int(min(num_eigs + oversample, max(n - 2, 1)))
    if rtol is None:
        rtol = 1e-5 if dtype == torch.float64 else 1e-4
    rng = np.random.default_rng(seed)
    Q0 = np.linalg.qr(rng.standard_normal((n, kp)))[0]

    def apply_block(Q):
        # columns as contiguous rows, so that each apply sees a
        # contiguous vector
        Qt = Q.T.contiguous()
        return torch.stack([apply_col(Qt[j]) for j in range(kp)], dim=1)

    Q = torch.as_tensor(Q0, dtype=dtype, device=device)
    it, rel = 0, float("inf")
    while it < iters and rel > rtol:
        Z = apply_block(Q)
        H = Q.T @ Z                      # Rayleigh-Ritz (nonsymmetric)
        Rres = Z[:, :num_eigs] - Q @ H[:, :num_eigs]
        rel = float(torch.linalg.norm(Rres) / torch.clamp(
            torch.linalg.norm(H[:, :num_eigs]), min=1e-30))
        Q, _r = torch.linalg.qr(Z)
        it += 1
    Z = apply_block(Q)
    H = Q.T @ Z
    if _info is not None:
        # +1: the final Ritz extraction costs one more block apply
        _info["applies"] = (it + 1) * kp
        _info["rel"] = rel
    Q = Q.to(torch.float64).cpu().numpy()
    H = H.to(torch.float64).cpu().numpy()
    vals, vecs = np.linalg.eig(H)
    order = np.argsort(-np.abs(vals), kind="stable")
    # real basis from (possibly complex-pair) Ritz vectors, the same
    # realification as the ARPACK path above
    Qf, _ = np.linalg.qr(Q @ _realify(vecs[:, order]))
    return Qf[:, :num_eigs]


def setup_deflation(V: np.ndarray, matvec: Callable, matvec_t: Callable,
                    projected_solve: Callable,
                    multi_solve: Optional[Callable] = None) -> Deflation:
    """Build the correction system (reference SetupDeflation):
      AV = K V;  R = solve((I-VV')AV);  D = V'AV - (K'V)' R.

    `matvec`/`matvec_t` may accept a 2-D block (a host scipy K @ V);
    `multi_solve`, when given, solves all k projected columns in one
    call (PAV (n, k) -> R (n, k)).  Everything is numpy in and out."""
    n, k = V.shape

    def block(mv):
        try:
            out = np.asarray(mv(V))
            assert out.shape == (n, k)
            return out
        except Exception:
            return np.column_stack([np.asarray(mv(V[:, j]))
                                    for j in range(k)])

    AV = block(matvec)
    # the part of AV orthogonal to V
    PAV = AV - V @ (V.T @ AV)
    if multi_solve is not None:
        R = np.asarray(multi_solve(PAV))
    else:
        R = np.column_stack([np.asarray(projected_solve(PAV[:, j]))
                             for j in range(k)])
    ATV = block(matvec_t)
    D = V.T @ AV - ATV.T @ R
    return Deflation(V=V, AV=AV, ATV=ATV, R=R, D=D)


def deflated_apply(defl: Deflation, b: np.ndarray,
                   projected_solve: Callable) -> np.ndarray:
    """One deflated solve (reference DeflatedSolver::ApplyInverse);
    numpy in and out."""
    V, R = defl.V, defl.R
    tmp = b - V @ (V.T @ b)
    Wb = np.asarray(projected_solve(tmp))
    w = defl.ATV.T @ Wb - V.T @ b
    v = defl.D_inv @ w
    return Wb + R @ v - V @ v
