"""Dense inverses and the single large dense factorization.

Torch counterpart of hymls_tpu/core/dense.py: library inverses
(`torch.linalg.inv`, LAPACK on the CPU and cuSOLVER on the card) with
a residual-adaptive Newton polish in f64, and the warm-started inverse
of value-only recomputes.  The coarse system takes the reference's two
branches by where it lives: off the CPU its explicit inverse at every
size, applied as one matrix-vector product; on the CPU the inverse up
to 2048 unknowns and LU factors above.  The TPU workarounds of the
reference (one-hot Gauss-Jordan, the Newton-Schulz-polished seed for
the coarse inverse, chunked batches) are not ported: the card has
native f32 and f64 LU.
"""
from __future__ import annotations

import torch

from ..utils.timings import count

# on the CPU, below this size the explicit inverse is cheap; above it
# the coarse system keeps its LU factors
# (hymls_tpu/core/dense.py:_LU_THRESHOLD)
_LU_THRESHOLD = 2048


def on_accelerator(A) -> bool:
    """Whether `A` lives off the CPU: the counterpart of the
    reference's `on_accelerator()`."""
    return A.device.type != "cpu"


def _matmul(A, B):
    """A @ B with the operands promoted to a common dtype, as JAX
    promotes (f32 factors applied to an f64 vector compute in f64)."""
    if A.dtype != B.dtype:
        dt = torch.promote_types(A.dtype, B.dtype)
        A, B = A.to(dt), B.to(dt)
    return torch.matmul(A, B)


def _batched_inv(A):
    """(Batched) dense inverse."""
    return torch.linalg.inv(A)


def _newton_refine(A, X, max_steps: int, tol: float = 1e-13):
    """Residual-adaptive Newton iteration X <- X + X(I - AX), until
    max|I - AX| <= tol or `max_steps`; a step that does not lower the
    residual is discarded (the reference's divergence guard).  The
    loop condition is read on the host, one scalar per step."""
    if A.numel() == 0:
        return X
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)

    def resid(X):
        return torch.max(torch.abs(eye - torch.matmul(A, X)))

    r = resid(X)
    it = 0
    while it < max_steps and bool(r > tol):
        R = eye - torch.matmul(A, X)
        Xn = X + torch.matmul(X, R)
        rn = resid(Xn)
        keep = rn <= r
        X = torch.where(keep, Xn, X)
        r = torch.where(keep, rn, r)
        it += 1
    return X


def inv_newton(A, refine: int = 6):
    """(Batched) dense inverse; in f64 polished by up to `refine`
    residual-adaptive Newton steps (explicit inverses of
    ill-conditioned blocks lose ~cond*eps, the polish recovers
    residual-level accuracy)."""
    X = _batched_inv(A)
    if A.dtype == torch.float64 and refine:
        X = _newton_refine(A, X, max_steps=refine)
    return X


def inv_chain(A, force_hybrid: bool = False):
    """The reference's inverse for the factor-upcast values chain.  By
    default the branch its CPU runs take: native f64 LU (the card has
    one too), so `inv_newton`.

    `force_hybrid` is the reference's accelerator branch, kept as a
    function and used by nothing on the solve paths: an f32 seed
    inverse and one fixed Newton step with the precision split, the
    residual R = I - A X in f64 (it is a cancellation) and the
    correction X R in f32 (|R| ~ 1e-5 makes its rounding O(1e-12)).
    Accurate to ~cond^2 eps32^2, enough for factors that are stored in
    f32 anyway."""
    if A.dtype != torch.float64 or not force_hybrid:
        return inv_newton(A)
    X32 = _batched_inv(A.to(torch.float32))
    X = X32.to(torch.float64)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    R = eye - torch.matmul(A, X)
    return X + torch.matmul(X32, R.to(torch.float32)).to(torch.float64)


def warm_inv(A, X0, fresh_fn=None, accept=0.25, max_steps=4, tol=None):
    """Warm-started (batched) dense inverse for value-only recomputes
    (Newton and continuation sequences).  When the previous inverse X0
    still contracts (max|I - A X0| < accept over the whole batch, one
    gate as in the reference's `lax.cond`), polish it with
    residual-adaptive Newton-Schulz steps; otherwise `fresh_fn(A)`
    (`inv_newton` by default).  The gate is read on the host: one
    scalar, so only the branch taken runs.  Counts the call in
    `hymls.warm.polish` or `hymls.warm.fresh`, by the branch taken."""
    if fresh_fn is None:
        fresh_fn = inv_newton
    if A.numel() == 0:
        return fresh_fn(A)
    X0 = X0.to(A.dtype)
    if tol is None:
        tol = 1e-13 if A.dtype == torch.float64 else 1e-6
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    r0 = torch.max(torch.abs(eye - torch.matmul(A, X0)))
    if bool(r0 < accept):
        count("hymls.warm.polish")
        return _newton_refine(A, X0, max_steps=max_steps, tol=tol)
    count("hymls.warm.fresh")
    return fresh_fn(A)


def warm_inv_chain(A, X0):
    """`inv_chain` warm-started, on the reference's CPU branch."""
    return warm_inv(A, X0, fresh_fn=inv_newton)


def dense_factor(A) -> dict:
    """Factor one (unbatched) dense system for repeated solves: off the
    CPU the inverse at every size, on the CPU the inverse up to 2048
    unknowns and LU factors above.  Counts each factor in
    `hymls.coarse.inverse` or `hymls.coarse.lu`, and its order in
    `hymls.coarse.unknowns`."""
    n = A.shape[-1]
    count("hymls.coarse.unknowns", n)
    if on_accelerator(A) or n <= _LU_THRESHOLD or A.dim() != 2:
        count("hymls.coarse.inverse")
        return {"inv": inv_newton(A)}
    count("hymls.coarse.lu")
    lu, piv = torch.linalg.lu_factor(A)
    return {"lu": lu, "piv": piv}


def dense_refactor(A, prev=None) -> dict:
    """`dense_factor` of new values of the same system.  Where `prev`,
    the last factor, is an explicit inverse, it is warm-started from it
    (`warm_inv`) and counted as `dense_factor` counts an inverse; LU
    factors are recomputed cold."""
    if prev is None or "inv" not in prev:
        return dense_factor(A)
    count("hymls.coarse.unknowns", A.shape[-1])
    count("hymls.coarse.inverse")
    return {"inv": warm_inv(A, prev["inv"])}


def dense_solve(fac: dict, rhs):
    """Solve against a `dense_factor` result; rhs (n,) or (n, k)."""
    if "inv" in fac:
        return _matmul(fac["inv"], rhs)
    lu = fac["lu"]
    if rhs.dtype != lu.dtype:
        dt = torch.promote_types(rhs.dtype, lu.dtype)
        lu, rhs = lu.to(dt), rhs.to(dt)
    if rhs.dim() == 1:
        return torch.linalg.lu_solve(lu, fac["piv"], rhs[:, None])[:, 0]
    return torch.linalg.lu_solve(lu, fac["piv"], rhs)
