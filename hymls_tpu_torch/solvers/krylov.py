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

On a CUDA device (and without `allreduce`) GMRES replays each
iteration's Arnoldi and Givens step (`_arnoldi`, everything after the
matvec and the preconditioner) from a CUDA graph captured once per
iteration index k on a workspace kept per (n, m, dtype, device)
(`GmresGraphs`): the same kernels on the same slices in the same order
as the eager loop, which every other solve runs, so the iterates are
equal bit for bit and the host issues one copy, one graph launch and
one read per iteration.  The graphs read no operator, preconditioner
or factorization, so a new Newton step captures nothing.  Counters
(`utils/timings.py`, always on): `hymls.gmres.graph_replays` and
`hymls.gmres.eager` per iteration, `hymls.gmres.graph_captures`.

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

import contextlib
import threading
import warnings
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import torch

from ..core.apply_graph import CudaGraphs
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
    iterations to the counter `hymls.gmres.iters`, and counts a solve
    that stopped at `maxiter` above `tol` in `hymls.gmres.capped`.

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
    _count_solve(res)
    return res


def _count_solve(res: KrylovResult) -> None:
    """A Krylov solve's counters: its iterations in `hymls.gmres.iters`,
    and in `hymls.gmres.capped` 1 where it stopped at its iteration cap
    above its tolerance, else 0 (so the counter exists once a solve
    ran)."""
    count("hymls.gmres.iters", res.iters)
    count("hymls.gmres.capped", int(not res.converged))


def _gmres(op, b, x0, prec, *, tol, maxiter, left, scale_with_rhs,
           allreduce, _scale=None) -> KrylovResult:
    """Full GMRES (`gmres` without a restart); `_scale`, a restart
    cycle's convergence scale, that of the whole solve.  Each iteration
    is the matvec, then `_arnoldi`: op by op (the eager loop), or, on a
    workspace of `_GRAPHS` (a CUDA b, no `allreduce`), replayed from a
    captured CUDA graph (`GmresGraphs`)."""
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

    with _GRAPHS.checkout(b, m, allreduce) as ws:
        if ws is None:
            V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
            R = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
            g = torch.zeros(m + 1, dtype=dtype, device=b.device)
            g[0] = beta.to(dtype)
            # accumulated Givens product, applied to each new column as
            # one matvec (rows/cols >= k+2 are still identity and the
            # column is zero there)
            Q = torch.eye(m + 1, dtype=dtype, device=b.device)
            units = _units(beta, dtype)

            def step(k, w):
                count("hymls.gmres.eager")
                return float(_arnoldi(V, R, g, Q, w, k, scale, units, norm,
                                      project))
        else:
            V, R, g = ws.V, ws.R, ws.g
            ws.start(beta, scale)
            step = ws.step
        V[0] = torch.where(beta > 0, r0 / beta, r0)

        res = float(beta / scale)
        done = res <= tol
        k = 0
        while k < m and not done:
            res = step(k, matop(V[k]))
            k += 1
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


def _units(beta, dtype):
    """(one, one_c, zero_c): norms and moduli are real tensors also for
    complex vectors; `one` is their unit, `one_c` and `zero_c` those of
    the vectors' dtype."""
    one = torch.ones((), dtype=beta.dtype, device=beta.device)
    one_c = one.to(dtype)
    return one, one_c, torch.zeros_like(one_c)


def _arnoldi(V, R, g, Q, w, k, scale, units, norm, project):
    """GMRES iteration k after its matvec w = matop(V[k]): CGS2 of w
    against V[:k+1], the new basis vector V[k+1], the new column of the
    Hessenberg matrix rotated by the Givens product Q, the rotation that
    zeroes its subdiagonal folded into Q and g, and the column into R.
    Writes V, R, g and Q in place and returns the implicit relative
    residual |g[k+1]| / scale, a 0-d tensor: nothing is read back to the
    host, so the eager loop runs it op by op and `GmresGraphs` captures
    it for each k."""
    dtype = V.dtype
    one, one_c, zero_c = units
    # CGS2 against basis vectors 0..k (the slice is the reference's
    # masked product: the rows above k are not part of it); conj() of a
    # real tensor is the tensor itself
    Vk = V[:k + 1]
    Vc = Vk.conj()
    h1 = project(Vc, w)
    w = w - torch.mv(Vk.T, h1)
    h2 = project(Vc, w)
    w = w - torch.mv(Vk.T, h2)
    hk1 = norm(w).to(dtype)
    V[k + 1] = torch.where(torch.abs(hk1) > 0, w / hk1, w)

    col = torch.zeros(V.shape[0], dtype=dtype, device=V.device)
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
    # a fill on the device: assigning the Python scalar 0.0 would copy
    # it from pageable host memory, a host sync that no graph captures
    col[k + 1].zero_()
    # fold G_k into Q: rows k and k+1 mix
    qk, qk1 = Q[k].clone(), Q[k + 1].clone()
    Q[k] = ck * qk + sk * qk1
    Q[k + 1] = -sk.conj() * qk + ck * qk1
    gk1 = -sk.conj() * g[k]
    g[k] = ck * g[k]
    g[k + 1] = gk1

    R[:, k] = col
    return torch.abs(gk1) / scale


class _Workspace:
    """One GMRES basis of m + 1 vectors of n entries, with R, g, Q, the
    static matvec input `w`, the static `scale`, the constants of
    `_units` and the residual's host scalar `res` (pinned on a CUDA
    device), and the graphs of `_arnoldi` on them, one per iteration
    index k, captured the first time a solve reaches k by `backend` (a
    `CudaGraphs` of its own: its side stream and memory pool)."""

    def __init__(self, n, m, dtype, device, backend):
        real = _REAL_OF.get(dtype, dtype)
        self.device, self.backend = device, backend
        self.V = torch.zeros((m + 1, n), dtype=dtype, device=device)
        self.R = torch.zeros((m + 1, m), dtype=dtype, device=device)
        self.g = torch.zeros(m + 1, dtype=dtype, device=device)
        self.Q = torch.empty((m + 1, m + 1), dtype=dtype, device=device)
        self.eye = torch.eye(m + 1, dtype=dtype, device=device)
        self.w = torch.zeros(n, dtype=dtype, device=device)
        self.scale = torch.ones((), dtype=real, device=device)
        self.units = _units(self.scale, dtype)
        self.res = torch.zeros((), dtype=real,
                               pin_memory=device.type == "cuda")
        self.graphs = {}        # k -> the graph of iteration k
        self.busy = False       # checked out by a solve
        self.failed = False     # a capture raised: eager from then on

    def start(self, beta, scale) -> None:
        """A new solve from beta = ||r0|| on the convergence scale:
        Q = I, g[0] = beta, the static scale; V[1:], R and the rest of
        g are written before they are read."""
        self.Q.copy_(self.eye)
        self.g[0] = beta.to(self.g.dtype)
        self.scale.copy_(scale)

    def _body(self, k):
        def body():
            self.res.copy_(_arnoldi(self.V, self.R, self.g, self.Q, self.w,
                                    k, self.scale, self.units,
                                    torch.linalg.norm, torch.mv),
                           non_blocking=True)
        return body

    def step(self, k, w) -> float:
        """Iteration k after its matvec w: replayed from its graph, or,
        the first time, run op by op on the backend's side stream and
        captured; returns the residual read on the host."""
        self.w.copy_(w)
        graph = self.graphs.get(k)
        if graph is not None:
            self.backend.replay(graph)
            count("hymls.gmres.graph_replays")
        else:
            body = self._body(k)
            if self.failed:
                body()
            else:
                self.backend.warm_up(body, self.device)
                self._capture(k, body)
            count("hymls.gmres.eager")
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.res.item()

    def _capture(self, k, body) -> None:
        try:
            self.graphs[k], _ = self.backend.capture(body, self.device)
        except Exception as e:
            self.failed = True
            self.graphs = {}
            warnings.warn(f"a GMRES iteration on {self.V.shape[1]} "
                          f"{self.V.dtype} unknowns could not be captured "
                          f"as a CUDA graph; its solves run eagerly: {e}",
                          RuntimeWarning)
            return
        count("hymls.gmres.graph_captures")


class GmresGraphs:
    """The GMRES workspaces of a process, one per (n, m, dtype, device),
    each with its captured iterations (`_Workspace`); at most `keep`,
    the least recently used dropped with its graphs.  A solve checks a
    workspace out while it runs: a solve started inside it (in its
    preconditioner, or on another thread) with the same key runs
    eagerly.  So does a solve with `allreduce` (its reductions are
    collectives), on another device type than `device_type`, or with a
    key whose capture once raised.  `backend` makes each workspace's
    capture backend (`CudaGraphs`); tests give a stand-in."""

    keep = 4

    def __init__(self, backend=CudaGraphs, device_type="cuda"):
        self.backend, self.device_type = backend, device_type
        self._spaces = OrderedDict()
        self._lock = threading.Lock()

    def _take(self, key):
        with self._lock:
            ws = self._spaces.get(key)
            if ws is None:
                if len(self._spaces) >= self.keep:
                    idle = [k for k, v in self._spaces.items() if not v.busy]
                    if not idle:
                        return None
                    del self._spaces[idle[0]]
                ws = self._spaces[key] = _Workspace(*key, self.backend())
            elif ws.busy or ws.failed:
                return None
            self._spaces.move_to_end(key)
            ws.busy = True
            return ws

    @contextlib.contextmanager
    def checkout(self, b, m, allreduce):
        """The workspace of b's shape, m and b's dtype and device, busy
        until the block ends, or None where the solve runs eagerly."""
        ws = None
        if allreduce is None and b.device.type == self.device_type:
            ws = self._take((b.shape[0], m, b.dtype, b.device))
        try:
            yield ws
        finally:
            if ws is not None:
                ws.busy = False


#: the process's GMRES workspaces and their graphs
_GRAPHS = GmresGraphs()


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
    in `gmres`.  Inside the span `hymls.cg`; counts as `gmres` does."""
    with prof("hymls.cg", 2):
        res = _cg(op, b, x0, prec, tol=tol, maxiter=maxiter,
                  scale_with_rhs=scale_with_rhs, allreduce=allreduce)
    _count_solve(res)
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
