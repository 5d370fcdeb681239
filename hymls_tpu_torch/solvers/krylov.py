"""Krylov solvers in torch: preconditioned GMRES and CG.

Torch counterpart of hymls_tpu/solvers/krylov.py, with the same
formulation so that f64 iteration counts match:

  * GMRES: Arnoldi with classical Gram-Schmidt with
    reorthogonalization (CGS2), and the Givens rotations kept as the
    dense accumulated product Q = G_{k-1}...G_0, applied to each new
    Hessenberg column as one matvec; full, or restarted every
    `restart` iterations (Belos 'Num Blocks').
  * CG: standard preconditioned conjugate gradients.

Convergence is measured as in Belos: the implicit residual norm scaled
by the norm of the (preconditioned, if left) initial residual, or of
the right-hand side with scale_with_rhs=True.

The loops are Python `while` loops: each iteration reads its residual
on the host once (one device synchronisation per iteration on CUDA).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int               # number of iterations performed
    relres: float            # final implicit relative residual
    converged: bool


_REAL_OF = {torch.complex128: torch.float64, torch.complex64: torch.float32}


def _as_dtype(v: float, dtype) -> float:
    """A Python scalar rounded to `dtype` (to its real type, for a
    complex one), so that host comparisons match the reference's
    in-dtype comparisons."""
    return float(torch.tensor(v, dtype=_REAL_OF.get(dtype, dtype)))


def gmres(op: Callable, b: torch.Tensor, x0: torch.Tensor,
          prec: Optional[Callable] = None, *, tol: float = 1e-8,
          maxiter: int = 100, left: bool = False,
          scale_with_rhs: bool = False, restart: Optional[int] = None,
          _scale=None) -> KrylovResult:
    """Preconditioned GMRES.

    op/prec: closures x -> A x and x -> M^{-1} x.
    left: left preconditioning (residual measured in preconditioned
    norm, like Belos); otherwise right preconditioning.
    restart: Krylov basis size (Belos 'Num Blocks'); None or
    >= maxiter runs full GMRES.  With a restart, cycles of `restart`
    iterations run until convergence or until `maxiter` iterations
    have been spent (the cycle under way runs to its end).
    _scale: a restart cycle's convergence scale, that of the whole
    solve."""
    if restart is not None and restart < maxiter:
        return _gmres_restarted(op, b, x0, prec, tol=tol, maxiter=maxiter,
                                left=left, scale_with_rhs=scale_with_rhs,
                                restart=restart)
    n = b.shape[0]
    dtype = b.dtype
    m = maxiter
    tol = _as_dtype(tol, dtype)
    if prec is None:
        prec = lambda x: x   # noqa: E731
        left = False

    def matop(v):
        return prec(op(v)) if left else op(prec(v))

    r0 = b - op(x0)
    if left:
        r0 = prec(r0)
    beta = torch.linalg.norm(r0)
    if _scale is not None:
        # restart cycles measure convergence against the scale of the
        # whole solve, not their own cycle-initial residual
        scale = _scale
    elif scale_with_rhs:
        scale = torch.linalg.norm(prec(b) if left else b)
    else:
        scale = beta
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))

    V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
    V[0] = torch.where(beta > 0, r0 / beta, r0)
    R = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
    g = torch.zeros(m + 1, dtype=dtype, device=b.device)
    g[0] = beta.to(dtype)
    # accumulated Givens product, applied to each new column as one
    # matvec (rows/cols >= k+2 are still identity and the column is
    # zero there)
    Q = torch.eye(m + 1, dtype=dtype, device=b.device)
    # norms and moduli are real tensors also for complex vectors: `one`
    # is their unit, `one_c` and `zero_c` those of the vectors' dtype
    one = torch.ones((), dtype=beta.dtype, device=b.device)
    one_c = one.to(dtype)
    zero_c = torch.zeros_like(one_c)

    res = float(beta / scale)
    done = res <= tol
    k = 0
    while k < m and not done:
        w = matop(V[k])
        # CGS2 against basis vectors 0..k (the rows above k are still
        # zero, so the slice equals the reference's masked product);
        # conj() of a real tensor is the tensor itself
        Vk = V[:k + 1]
        Vc = Vk.conj()
        h1 = torch.mv(Vc, w)
        w = w - torch.mv(Vk.T, h1)
        h2 = torch.mv(Vc, w)
        w = w - torch.mv(Vk.T, h2)
        hk1 = torch.linalg.norm(w).to(dtype)
        V[k + 1] = torch.where(torch.abs(hk1) > 0, w / hk1, w)

        col = torch.zeros(m + 1, dtype=dtype, device=b.device)
        col[:k + 1] = h1 + h2
        col[k + 1] = hk1
        col = torch.mv(Q, col)

        # new rotation zeroing col[k+1] (complex-safe Givens: c real,
        # s = sgn(a) conj(b) / r)
        a, bb = col[k], col[k + 1]
        denom = torch.sqrt(torch.abs(a) ** 2 + torch.abs(bb) ** 2)
        absa = torch.abs(a)
        ck = torch.where(denom > 0, absa / denom, one).to(dtype)
        sgn = torch.where(absa > 0, a / torch.where(absa > 0, absa, one),
                          one_c)
        sk = torch.where(denom > 0, sgn * bb.conj() / denom, zero_c)
        col[k] = denom * sgn
        col[k + 1] = 0.0
        # fold G_k into Q: rows k and k+1 mix
        qk, qk1 = Q[k].clone(), Q[k + 1].clone()
        Q[k] = ck * qk + sk * qk1
        Q[k + 1] = -sk.conj() * qk + ck * qk1
        gk1 = -sk.conj() * g[k]
        g[k] = ck * g[k]
        g[k + 1] = gk1

        R[:, k] = col
        k += 1
        res = float(torch.abs(gk1) / scale)
        done = res <= tol

    # solve R[:k,:k] y = g[:k]; correction in the Krylov basis
    if k:
        y = torch.linalg.solve_triangular(R[:k, :k], g[:k, None],
                                          upper=True)[:, 0]
        dx = torch.mv(V[:k].T, y)
        x = x0 + (dx if left else prec(dx))
    else:
        x = x0.clone()
    return KrylovResult(x=x, iters=k, relres=res, converged=done)


def _gmres_restarted(op, b, x0, prec, *, tol, maxiter, left,
                     scale_with_rhs, restart) -> KrylovResult:
    """Restart loop around fixed-basis GMRES cycles, on the host.  The
    convergence scale is fixed once for the whole solve (Belos scales
    by the solve's initial residual or right-hand side, never by a
    cycle's restart residual: otherwise every cycle would need the full
    relative reduction on its own)."""
    r0 = b - op(x0)
    if left and prec is not None:
        r0 = prec(r0)
    if scale_with_rhs:
        scale0 = torch.linalg.norm(
            prec(b) if (left and prec is not None) else b)
    else:
        scale0 = torch.linalg.norm(r0)
    scale0 = torch.where(scale0 > 0, scale0, torch.ones_like(scale0))

    x, k, res, done = x0, 0, float("inf"), False
    while not done and k < maxiter:
        inner = gmres(op, b, x, prec, tol=tol, maxiter=restart, left=left,
                      scale_with_rhs=scale_with_rhs, _scale=scale0)
        x, k, res, done = inner.x, k + inner.iters, inner.relres, \
            inner.converged
    return KrylovResult(x=x, iters=k, relres=res, converged=done)


def cg(op: Callable, b: torch.Tensor, x0: torch.Tensor,
       prec: Optional[Callable] = None, *, tol: float = 1e-8,
       maxiter: int = 100, scale_with_rhs: bool = False) -> KrylovResult:
    """Preconditioned conjugate gradients.  Works on negative-definite
    systems too (the CG formulas are invariant under a simultaneous
    sign flip of the operator and the preconditioner)."""
    if prec is None:
        prec = lambda x: x   # noqa: E731
    tol = _as_dtype(tol, b.dtype)

    r = b - op(x0)
    z = prec(r)
    scale = torch.linalg.norm(b) if scale_with_rhs else torch.linalg.norm(r)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    rz = torch.dot(r, z)
    x, p = x0, z
    res = float(torch.linalg.norm(r) / scale)
    done = res <= tol
    k = 0
    while k < maxiter and not done:
        Ap = op(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        res = float(torch.linalg.norm(r) / scale)
        done = res <= tol
    return KrylovResult(x=x, iters=k, relres=res, converged=done)
