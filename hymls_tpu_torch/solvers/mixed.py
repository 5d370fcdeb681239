"""Mixed-precision solves: f32 Krylov + preconditioner inside an f64
iterative-refinement loop.

Torch counterpart of hymls_tpu/solvers/mixed.py.  All heavy work
(factorization, V-cycles, Krylov iterations, the f32 SpMV) runs in
f32, while the residual and the solution accumulate in f64: each pass
solves for the correction of the f64 residual to a loose, adaptive
inner tolerance, and the refinement loop carries the result to the
outer tolerance.  The f64 residual goes through an f64 DiaOperator, so
the DIA kernel runs in f64 as well as in f32.  Under 'Distributed Apply'
with a mesh, the refinement loop stays replicated around the structured
apply sharded over the ranks when the structured program is active
(reference mixed.py:139-155); else the whole Newton step runs
owner-sharded (reference mixed.py:219-296).  One refinement loop
(`IterativeRefinementSolver.refine`) serves every layout and the
bordered solve.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp

import torch

from ..config import Params
from ..core.preconditioner import Preconditioner
from ..ops.spmv import make_operator
from ..utils.timings import count, profiled, prof
from .solver import Solver
from .krylov import KrylovResult
from . import krylov


def _identity(x):
    return x


class _Loop(NamedTuple):
    """What the refinement loop takes from where its vectors live: the
    f64 residual's operator K x, the inner solve (r32, rel) ->
    KrylovResult of a pass, the global norm, and the scatter of b and
    gather of x (the identity on whole vectors)."""
    residual: Callable
    inner: Callable
    norm: Callable = torch.linalg.norm
    scatter: Callable = _identity
    gather: Callable = _identity


class IterativeRefinementSolver:
    """Drop-in alternative to Solver with the same apply_inverse API."""

    def __init__(self, K: sp.csr_matrix, params: Params,
                 testvector: Optional[np.ndarray] = None,
                 inner_tol: float = 1e-4, max_passes: int = 16,
                 inner_maxiter: Optional[int] = None, *, device):
        self.params = params
        self.device = torch.device(device)
        it = params.sublist("Solver").sublist("Iterative Solver")
        self.tol = it.get("Convergence Tolerance", 1e-6)
        self.inner_tol = max(inner_tol, self.tol)
        self.max_passes = max_passes
        if inner_maxiter is None:
            # the inner-basis rule of the reference: 96 slots for
            # multilevel problems, the cheaper 64 for one reduction
            n_levels = params.sublist("Preconditioner").get(
                "Number of Levels", 1)
            inner_maxiter = 96 if n_levels >= 2 else 64
        self.inner_maxiter = min(
            it.get("Inner Maximum Iterations", inner_maxiter),
            it.get("Maximum Iterations", 100))

        inner_params = params.copy()
        inner_params.sublist("Solver").sublist("Iterative Solver")[
            "Convergence Tolerance"] = self.inner_tol
        inner_params.sublist("Solver").sublist("Iterative Solver")[
            "Maximum Iterations"] = self.inner_maxiter
        # factor assembly defaults to 'Same' (the all-f32 chain);
        # 'Factor Precision' = 'f64' opts into f64 assembly with f32
        # factors, for matrices that cancel beyond f32 range
        fprec = params.sublist("Preconditioner").get("Factor Precision",
                                                     "Same")
        # the distributed factorization (parallel/dist_compute.py)
        # implements the full-f64 chain: pin the replicated build to the
        # same assembly, so that distributed and replicated steps agree
        if params.sublist("Solver").get("Distributed Apply", False) and \
                "Schur Assembly" not in params.sublist("Preconditioner"):
            inner_params.sublist("Preconditioner")[
                "Schur Assembly"] = "Full f64"
        self.precond = Preconditioner(
            K, inner_params, testvector=testvector, dtype=torch.float32,
            factor_dtype=torch.float64 if fprec == "f64" else torch.float32,
            device=device)
        self.solver = Solver(K, self.precond, inner_params,
                             dtype=torch.float32, device=device)
        self.op64 = make_operator(K, dtype=torch.float64, device=device)
        self._last_result = None

    def compute(self, K: Optional[sp.csr_matrix] = None):
        self.precond.compute(K)
        if K is not None:
            self.solver.set_matrix(K)
            self.op64.set_values(K.tocsr().data)
        return self

    def set_border(self, V, W=None, C=None):
        self.solver.set_border(V, W, C)
        return self

    @profiled("hymls.refine", 1)
    def refine(self, b, loop: _Loop) -> KrylovResult:
        """The refinement loop: f64 residual -> f32 correction -> f64
        update, until the true relative residual reaches the outer
        tolerance or `max_passes` passes ran.  `loop` says where the
        vectors live and how each pass solves (`_replicated`, `_owner`,
        `apply_inverse`); `iters` counts the inner f32 iterations of all
        passes, and x comes back global.  Inside the span `hymls.refine`,
        each pass's f64 residual inside `hymls.refine.residual`; counts
        the solve in `hymls.refine.solves`, each pass in
        `hymls.refine.passes`, and in `hymls.refine.capped` a solve
        that stopped at `max_passes` above the tolerance."""
        count("hymls.refine.solves")
        b = loop.scatter(b)
        nb = float(loop.norm(b))
        nb = nb if nb > 0 else 1.0
        x = torch.zeros_like(b)
        r = b
        rel = float(loop.norm(r)) / nb
        iters = passes = 0
        while rel > self.tol and passes < self.max_passes:
            res = loop.inner(r.to(torch.float32), rel)
            x = x + res.x.to(torch.float64)
            with prof("hymls.refine.residual", 2):
                r = b - loop.residual(x)
                rel = float(loop.norm(r)) / nb
            iters += res.iters
            passes += 1
            count("hymls.refine.passes")
        if rel > self.tol:
            count("hymls.refine.capped")
        return KrylovResult(x=loop.gather(x), iters=iters, relres=rel,
                            converged=rel <= self.tol)

    def _krylov(self, op, prec, **kw):
        """The inner solve of a pass: f32 CG or GMRES (by the solver's
        method) on `op` and `prec` from a zero start, to the adaptive
        target of the reference (mixed.py:193-201): the last pass only
        needs the reduction that carries rel to the outer tolerance;
        0.3 covers implicit-vs-true slack."""
        cg = self.solver.method == "CG"

        def inner(r32, rel):
            tol_k = float(np.float32(np.clip(0.3 * self.tol / rel,
                                             self.inner_tol, 0.3)))
            solve = krylov.cg if cg else krylov.gmres
            return solve(op, r32, torch.zeros_like(r32), prec, tol=tol_k,
                         maxiter=self.inner_maxiter, **kw)
        return inner

    def _replicated(self, vals64, vals32, fac, sapply) -> _Loop:
        """The loop on whole vectors: the operators in f32 and f64
        and the V-cycle of the `Factors` value `fac`, through the sharded
        structured apply `sapply` where there is one."""
        pv64 = self.op64.prepare(vals64)
        pv32 = self.solver.op.prepare(vals32)
        mv32, mv64 = self.solver.op.matvec_prepared, self.op64.matvec_prepared
        apply_fn = sapply or self.precond.apply_fn
        return _Loop(
            residual=lambda x: mv64(pv64, x),
            inner=self._krylov(lambda x: mv32(pv32, x),
                               lambda x: apply_fn(fac, x)))

    def _owner(self, dist, vals64, vals32, fac_st) -> _Loop:
        """The loop in the owner layout (reference mixed.py:
        _build_fused_dist): the halo matvec in f32 and f64, the halo
        V-cycle on this rank's factors `fac_st`, and every norm and
        Krylov reduction a psum, so that all ranks take the same
        passes."""
        pv64, pv32 = dist.prepare(vals64), dist.prepare(vals32)
        return _Loop(
            residual=lambda x: dist.matvec(pv64, x),
            inner=self._krylov(lambda x: dist.matvec(pv32, x),
                               lambda x: dist.precond(fac_st, x),
                               allreduce=dist.allreduce),
            norm=dist.norm, scatter=dist.scatter, gather=dist.gather)

    def _dist(self):
        """Under 'Distributed Apply', (sapply, None) with the sharded
        structured apply (Solver._make_dist_structured) or else
        (None, dist) with this rank's owner-sharded operator and apply
        pair (Solver._make_dist); (None, None) without."""
        if not self.solver.distributed:
            return None, None
        sapply = self.solver._make_dist_structured()
        if sapply is not None:
            return sapply, None
        return None, self.solver._make_dist()

    def _solve(self, vals64, vals32, b, fac, sapply, dist) -> KrylovResult:
        """The refinement solve of b on the values (vals64, vals32) in
        the layout that `_dist` picked: on whole vectors around the
        V-cycle of the `Factors` value `fac` (through the sharded
        structured apply `sapply` where there is one), or with `dist`
        in the owner layout around this rank's halo-layout factors
        `fac`."""
        b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
        loop = self._replicated(vals64, vals32, fac, sapply) \
            if dist is None else self._owner(dist, vals64, vals32, fac)
        res = self._last_result = self.refine(b, loop)
        return res

    def newton_step(self, vals64, vals32, b) -> KrylovResult:
        """One Newton step: f32 re-factorization from the f64 values
        (`Preconditioner.factorize`), then the refinement solve (the
        counterpart of the reference's `newton_step_fn` program).
        Distributed with the structured program active: the replicated
        factorization, and the refinement loop on the sharded
        structured apply; else the factorization of
        parallel/dist_compute.py where the structure allows it, straight
        into the owner-layout loop."""
        sapply, dist = self._dist()

        def factorize():
            return self.precond.factorize(vals64)
        fac = factorize() if dist is None else \
            dist.factors(vals64, factorize)
        return self._solve(vals64, vals32, b, fac, sapply, dist)

    def newton_step_warm(self, vals64, vals32, b, prev):
        """`newton_step` threading the factorization through a Newton
        sequence (the counterpart of the reference's
        `newton_step_warm_fn`): the dense inverses are polished from the
        `Factors` value `prev` (seed it with `precond.factors` of a cold
        compute), each with its residual-gated cold fallback; the
        distributed solve runs around the replicated warm recompute.
        Returns (KrylovResult, the new Factors) for the next step."""
        sapply, dist = self._dist()
        fac = self.precond.factorize(vals64, prev)
        res = self._solve(vals64, vals32, b, fac if dist is None else
                          dist.stack_factors(fac.pruned), sapply, dist)
        return res, fac

    def solve(self, b):
        """Refinement solve with the current factors; returns x."""
        sapply, dist = self._dist()
        fac = self.precond.factors
        return self._solve(self.op64.vals, self.solver.op.vals, b,
                           fac if dist is None else
                           dist.stack_factors(fac.pruned), sapply, dist).x

    def apply_inverse(self, b):
        """Refinement solve through `Solver.apply_inverse` passes at the
        solver's fixed inner tolerance (the bordered path); returns
        (x, KrylovResult)."""
        b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
        pv64 = self.op64.prepare(self.op64.vals)

        def inner(r32, rel):
            d, res = self.solver.apply_inverse(r32)
            return res._replace(x=d)

        res = self._last_result = self.refine(b, _Loop(
            residual=lambda x: self.op64.matvec_prepared(pv64, x),
            inner=inner))
        return res.x, res

    @property
    def num_iter(self) -> int:
        return 0 if self._last_result is None else self._last_result.iters
