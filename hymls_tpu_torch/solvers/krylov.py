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

`gmres_batched` runs nb systems at once, one per row of a block, with
the semantics of the JAX package's `jax.vmap(krylov.gmres)`.

`allreduce` (a function that sums a tensor over the ranks of a mesh,
parallel/dist.py's `DistributedSolve.allreduce`) runs a loop on
owner-sharded vectors: every dot, norm and Gram-Schmidt projection is
the rank-local product completed by one reduction (per CGS2 pass: one
local GEMV, then one reduction of the coefficient vector), and every
branch and host read (convergence, the Givens rotations, restarts)
comes from reduced values only, so that all ranks take the same path.
Without it the loops are the single-process ones.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.timings import count, prof


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int               # number of iterations performed
    relres: float            # final implicit relative residual
    converged: bool


_REAL_OF = {torch.complex128: torch.float64, torch.complex64: torch.float32}


def _reductions(allreduce):
    """(norm, mv, dot) for the loops: the plain torch functions, or
    their rank-local versions completed by `allreduce`."""
    if allreduce is None:
        return torch.linalg.norm, torch.mv, torch.dot

    def norm(v):
        return torch.sqrt(allreduce(torch.sum((v.conj() * v).real)))

    def mv(A, w):
        return allreduce(torch.mv(A, w))

    def dot(a, b):
        return allreduce(torch.dot(a, b))
    return norm, mv, dot


def _as_dtype(v: float, dtype) -> float:
    """A Python scalar rounded to `dtype` (to its real type, for a
    complex one), so that host comparisons match the reference's
    in-dtype comparisons."""
    return float(torch.tensor(v, dtype=_REAL_OF.get(dtype, dtype)))


def gmres(op: Callable, b: torch.Tensor, x0: torch.Tensor,
          prec: Optional[Callable] = None, *, tol: float = 1e-8,
          maxiter: int = 100, left: bool = False,
          scale_with_rhs: bool = False, restart: Optional[int] = None,
          allreduce: Optional[Callable] = None) -> KrylovResult:
    """Preconditioned GMRES, inside the span `hymls.gmres`; adds its
    iterations to the counter `hymls.gmres.iters`.

    op/prec: closures x -> A x and x -> M^{-1} x.
    left: left preconditioning (residual measured in preconditioned
    norm, like Belos); otherwise right preconditioning.
    restart: Krylov basis size (Belos 'Num Blocks'); None or
    >= maxiter runs full GMRES.  With a restart, cycles of `restart`
    iterations run until convergence or until `maxiter` iterations
    have been spent (the cycle under way runs to its end).
    allreduce: the sum over the ranks, for owner-sharded vectors (see
    the module docstring)."""
    with prof("hymls.gmres", 2):
        if restart is not None and restart < maxiter:
            res = _gmres_restarted(op, b, x0, prec, tol=tol,
                                   maxiter=maxiter, left=left,
                                   scale_with_rhs=scale_with_rhs,
                                   restart=restart, allreduce=allreduce)
        else:
            res = _gmres(op, b, x0, prec, tol=tol, maxiter=maxiter,
                         left=left, scale_with_rhs=scale_with_rhs,
                         allreduce=allreduce)
    count("hymls.gmres.iters", res.iters)
    return res


def _gmres(op, b, x0, prec, *, tol, maxiter, left, scale_with_rhs,
           allreduce, _scale=None) -> KrylovResult:
    """Full GMRES (`gmres` without a restart); `_scale`, a restart
    cycle's convergence scale, that of the whole solve."""
    norm, project, _ = _reductions(allreduce)
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
    beta = norm(r0)
    if _scale is not None:
        # restart cycles measure convergence against the scale of the
        # whole solve, not their own cycle-initial residual
        scale = _scale
    elif scale_with_rhs:
        scale = norm(prec(b) if left else b)
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
        h1 = project(Vc, w)
        w = w - torch.mv(Vk.T, h1)
        h2 = project(Vc, w)
        w = w - torch.mv(Vk.T, h2)
        hk1 = norm(w).to(dtype)
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


def gmres_batched(op: Callable, B: torch.Tensor, X0: torch.Tensor,
                  prec: Optional[Callable] = None, *, tol: float = 1e-8,
                  maxiter: int = 100, left: bool = False) -> KrylovResult:
    """`gmres` on nb real systems at once, one per row of B (nb, n) and
    X0 (nb, n): the semantics of the JAX package's
    `jax.vmap(krylov.gmres)`.  op and prec map an (nb, n) block to an
    (nb, n) block.

    Every system has its own Krylov basis (V is (m+1, nb, n), so that
    the block of the k-th basis vectors is one contiguous (nb, n)
    tensor), its own Givens product, residual, scale and convergence
    test; CGS2 runs as batched products.  The loop runs while any
    system is active, op and prec always on the whole block, and a
    system that has converged keeps its state frozen, as the vmapped
    `lax.while_loop` keeps it through `select`.  One host read per
    iteration: whether any system is still active.

    Returns a KrylovResult of tensors: x (nb, n), iters (nb,),
    relres (nb,) and converged (nb,)."""
    nb, n = B.shape
    dtype, dev = B.dtype, B.device
    m = maxiter
    tol = _as_dtype(tol, dtype)
    if prec is None:
        prec = lambda x: x   # noqa: E731
        left = False

    def matop(v):
        return prec(op(v)) if left else op(prec(v))

    r0 = B - op(X0)
    if left:
        r0 = prec(r0)
    beta = torch.linalg.norm(r0, dim=1)
    scale = torch.where(beta > 0, beta, torch.ones_like(beta))

    V = torch.zeros((m + 1, nb, n), dtype=dtype, device=dev)
    V[0] = torch.where(beta[:, None] > 0, r0 / beta[:, None], r0)
    R = torch.zeros((nb, m + 1, m), dtype=dtype, device=dev)
    g = torch.zeros((nb, m + 1), dtype=dtype, device=dev)
    g[:, 0] = beta
    Q = torch.eye(m + 1, dtype=dtype, device=dev).repeat(nb, 1, 1)
    one = torch.ones((), dtype=dtype, device=dev)

    res = beta / scale
    active = ~(res <= tol)
    iters = torch.zeros(nb, dtype=torch.int64, device=dev)
    k = 0
    while k < m and bool(active.any()):
        w = matop(V[k])
        # CGS2 of each system against its basis vectors 0..k
        Vk = V[:k + 1].transpose(0, 1)                  # (nb, k+1, n)
        h1 = torch.bmm(Vk, w[:, :, None])[:, :, 0]
        w = w - torch.bmm(h1[:, None, :], Vk)[:, 0]
        h2 = torch.bmm(Vk, w[:, :, None])[:, :, 0]
        w = w - torch.bmm(h2[:, None, :], Vk)[:, 0]
        hk1 = torch.linalg.norm(w, dim=1)
        act = active[:, None]
        V[k + 1] = torch.where(
            act, torch.where(hk1[:, None] > 0, w / hk1[:, None], w),
            V[k + 1])

        col = torch.zeros((nb, m + 1), dtype=dtype, device=dev)
        col[:, :k + 1] = h1 + h2
        col[:, k + 1] = hk1
        col = torch.bmm(Q, col[:, :, None])[:, :, 0]

        # the new rotation zeroing col[k+1], per system
        a, bb = col[:, k], col[:, k + 1]
        denom = torch.sqrt(a * a + bb * bb)
        absa = torch.abs(a)
        ck = torch.where(denom > 0, absa / denom, one)
        sgn = torch.where(absa > 0, a / torch.where(absa > 0, absa, one),
                          one)
        sk = torch.where(denom > 0, sgn * bb / denom, torch.zeros_like(a))
        col[:, k] = denom * sgn
        col[:, k + 1] = 0.0
        # fold G_k into Q and g; frozen systems keep theirs
        qk, qk1 = Q[:, k].clone(), Q[:, k + 1].clone()
        Q[:, k] = torch.where(act, ck[:, None] * qk + sk[:, None] * qk1, qk)
        Q[:, k + 1] = torch.where(act, -sk[:, None] * qk + ck[:, None] * qk1,
                                  qk1)
        gk = g[:, k].clone()
        gk1 = -sk * gk
        g[:, k] = torch.where(active, ck * gk, gk)
        g[:, k + 1] = torch.where(active, gk1, g[:, k + 1])
        R[:, :, k] = torch.where(act, col, R[:, :, k])
        res = torch.where(active, torch.abs(gk1) / scale, res)
        iters = iters + active
        active = active & ~(res <= tol)
        k += 1

    if k:
        # R[:k, :k] y = g[:k] per system, the rows past its own count
        # masked to identity (its y is zero there), as the reference
        j = torch.arange(k, device=dev)
        live = j[None, :] < iters[:, None]
        Rm = R[:, :k, :k] + torch.diag_embed((~live).to(dtype))
        gm = torch.where(live, g[:, :k], torch.zeros_like(g[:, :k]))
        y = torch.linalg.solve_triangular(Rm, gm[:, :, None],
                                          upper=True)[:, :, 0]
        dx = torch.bmm(y[:, None, :], V[:k].transpose(0, 1))[:, 0]
        X = X0 + (dx if left else prec(dx))
    else:
        X = X0.clone()
    return KrylovResult(x=X, iters=iters, relres=res,
                        converged=res <= tol)


def _gmres_restarted(op, b, x0, prec, *, tol, maxiter, left,
                     scale_with_rhs, restart, allreduce=None) -> KrylovResult:
    """Restart loop around fixed-basis GMRES cycles, on the host.  The
    convergence scale is fixed once for the whole solve (Belos scales
    by the solve's initial residual or right-hand side, never by a
    cycle's restart residual: otherwise every cycle would need the full
    relative reduction on its own)."""
    norm = _reductions(allreduce)[0]
    r0 = b - op(x0)
    if left and prec is not None:
        r0 = prec(r0)
    if scale_with_rhs:
        scale0 = norm(prec(b) if (left and prec is not None) else b)
    else:
        scale0 = norm(r0)
    scale0 = torch.where(scale0 > 0, scale0, torch.ones_like(scale0))

    x, k, res, done = x0, 0, float("inf"), False
    while not done and k < maxiter:
        inner = _gmres(op, b, x, prec, tol=tol, maxiter=restart, left=left,
                       scale_with_rhs=scale_with_rhs, allreduce=allreduce,
                       _scale=scale0)
        x, k, res, done = inner.x, k + inner.iters, inner.relres, \
            inner.converged
    return KrylovResult(x=x, iters=k, relres=res, converged=done)


def cg(op: Callable, b: torch.Tensor, x0: torch.Tensor,
       prec: Optional[Callable] = None, *, tol: float = 1e-8,
       maxiter: int = 100, scale_with_rhs: bool = False,
       allreduce: Optional[Callable] = None) -> KrylovResult:
    """Preconditioned conjugate gradients.  Works on negative-definite
    systems too (the CG formulas are invariant under a simultaneous
    sign flip of the operator and the preconditioner).  `allreduce` as
    in `gmres`.  Inside the span `hymls.cg`; adds its iterations to the
    counter `hymls.gmres.iters`."""
    with prof("hymls.cg", 2):
        res = _cg(op, b, x0, prec, tol=tol, maxiter=maxiter,
                  scale_with_rhs=scale_with_rhs, allreduce=allreduce)
    count("hymls.gmres.iters", res.iters)
    return res


def _cg(op, b, x0, prec, *, tol, maxiter, scale_with_rhs,
        allreduce) -> KrylovResult:
    norm, _, dot = _reductions(allreduce)
    if prec is None:
        prec = lambda x: x   # noqa: E731
    tol = _as_dtype(tol, b.dtype)

    r = b - op(x0)
    z = prec(r)
    scale = norm(b) if scale_with_rhs else norm(r)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    rz = dot(r, z)
    x, p = x0, z
    res = float(norm(r) / scale)
    done = res <= tol
    k = 0
    while k < maxiter and not done:
        Ap = op(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        res = float(norm(r) / scale)
        done = res <= tol
    return KrylovResult(x=x, iters=k, relres=res, converged=done)
