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
owner-sharded (`refine_dist`, reference mixed.py:219-296).
"""
from __future__ import annotations

from typing import Optional

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
    def refine(self, vals64, vals32, factors, aplans, b,
               apply_fn=None) -> KrylovResult:
        """The refinement loop: f64 residual -> f32 Krylov correction ->
        f64 update, until the true relative residual reaches the outer
        tolerance or `max_passes` passes ran.  `iters` counts the inner
        f32 iterations of all passes.  `apply_fn` (default the
        preconditioner's own) is the sharded structured apply under
        'Distributed Apply'.  Inside the span `hymls.refine`, each pass's
        f64 residual inside `hymls.refine.residual`; counts the solve in
        `hymls.refine.solves` and each pass in `hymls.refine.passes`."""
        count("hymls.refine.solves")
        pv64 = self.op64.prepare(vals64)
        pv32 = self.solver.op.prepare(vals32)
        mv32 = self.solver.op.matvec_prepared
        mv64 = self.op64.matvec_prepared
        apply_fn = apply_fn or self.precond.apply_fn
        cg = self.solver.method == "CG"
        nb = float(torch.linalg.norm(b))
        nb = nb if nb > 0 else 1.0

        def op(x):
            return mv32(pv32, x)

        def prec(x):
            return apply_fn(factors, aplans, x)

        x = torch.zeros_like(b)
        r = b
        rel = float(torch.linalg.norm(r)) / nb
        iters = passes = 0
        while rel > self.tol and passes < self.max_passes:
            # adaptive inner target (reference mixed.py:193-201): the
            # last pass only needs the reduction that carries rel to the
            # outer tolerance; 0.3 covers implicit-vs-true slack
            tol_k = float(np.float32(np.clip(0.3 * self.tol / rel,
                                             self.inner_tol, 0.3)))
            r32 = r.to(torch.float32)
            x32 = torch.zeros_like(r32)
            if cg:
                res = krylov.cg(op, r32, x32, prec, tol=tol_k,
                                maxiter=self.inner_maxiter)
            else:
                res = krylov.gmres(op, r32, x32, prec, tol=tol_k,
                                   maxiter=self.inner_maxiter)
            x = x + res.x.to(torch.float64)
            with prof("hymls.refine.residual", 2):
                r = b - mv64(pv64, x)
                rel = float(torch.linalg.norm(r)) / nb
            iters += res.iters
            passes += 1
            count("hymls.refine.passes")
        return KrylovResult(x=x, iters=iters, relres=rel,
                            converged=rel <= self.tol)

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

    @profiled("hymls.refine", 1)
    def refine_dist(self, dist, vals64, vals32, fac_st, b) -> KrylovResult:
        """`refine` in the owner layout (reference mixed.py:
        _build_fused_dist): f32 inner GMRES on the halo matvec and halo
        V-cycle, the f64 residual through the same exchange matvec, and
        every norm a psum, so that all ranks take the same passes.
        Returns the result with the global x.  Spans and counters as
        `refine`."""
        count("hymls.refine.solves")
        pv64, pv32 = dist.prepare(vals64), dist.prepare(vals32)
        cg = self.solver.method == "CG"
        b_l = dist.scatter(b)
        nb = float(dist.norm(b_l))
        nb = nb if nb > 0 else 1.0

        def op(x):
            return dist.matvec(pv32, x)

        def prec(x):
            return dist.precond(fac_st, x)

        x = torch.zeros_like(b_l)
        r = b_l
        rel = float(dist.norm(r)) / nb
        iters = passes = 0
        while rel > self.tol and passes < self.max_passes:
            tol_k = float(np.float32(np.clip(0.3 * self.tol / rel,
                                             self.inner_tol, 0.3)))
            r32 = r.to(torch.float32)
            x32 = torch.zeros_like(r32)
            kw = dict(tol=tol_k, maxiter=self.inner_maxiter,
                      allreduce=dist.allreduce)
            res = krylov.cg(op, r32, x32, prec, **kw) if cg else \
                krylov.gmres(op, r32, x32, prec, **kw)
            x = x + res.x.to(torch.float64)
            with prof("hymls.refine.residual", 2):
                r = b_l - dist.matvec(pv64, x)
                rel = float(dist.norm(r)) / nb
            iters += res.iters
            passes += 1
            count("hymls.refine.passes")
        return KrylovResult(x=dist.gather(x), iters=iters, relres=rel,
                            converged=rel <= self.tol)

    def newton_step(self, vals64, vals32, b) -> KrylovResult:
        """One Newton step: f32 re-factorization from the f64 values,
        the structured repack when that apply is active, then the
        refinement solve (the counterpart of the reference's
        `newton_step_fn` program).  Distributed with the structured
        program active: the replicated factorization and repack, and the
        refinement loop on the sharded structured apply; else the
        factorization of parallel/dist_compute.py straight into
        `refine_dist`."""
        P = self.precond
        sapply, dist = self._dist()
        if dist is not None:
            b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
            fac_st = dist.compute(vals64) if dist.dcompute is not None \
                else dist.stack_factors(P._prune_factors(
                    P.compute_fn(vals64, P._dplans, P._extra_plan)))
            res = self.refine_dist(dist, vals64, vals32, fac_st, b)
            self._last_result = res
            return res
        factors = P.apply_factors_from(P.compute_fn(vals64, P._dplans,
                                                    P._extra_plan))
        b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
        res = self.refine(vals64, vals32, factors, P._aplans, b, sapply)
        self._last_result = res
        return res

    def newton_step_warm(self, vals64, vals32, b, prev):
        """`newton_step` threading the factor tree through a Newton
        sequence (the counterpart of the reference's
        `newton_step_warm_fn`): the dense inverses are polished from
        `prev` (seed it with `precond.factors` of a cold compute), each
        with its residual-gated cold fallback.  Returns
        (KrylovResult, factors) with the unpruned factor tree for the
        next step."""
        P = self.precond
        sapply, dist = self._dist()
        factors = P.compute_fn(vals64, P._dplans, P._extra_plan, prev=prev)
        b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
        if dist is not None:
            # the distributed solve around the replicated warm recompute
            res = self.refine_dist(
                dist, vals64, vals32,
                dist.stack_factors(P._prune_factors(factors)), b)
        else:
            res = self.refine(vals64, vals32, P.apply_factors_from(factors),
                              P._aplans, b, sapply)
        self._last_result = res
        return res, factors

    def solve(self, b):
        """Refinement solve with the current factors; returns x."""
        b = torch.as_tensor(b, dtype=torch.float64, device=self.device)
        sapply, dist = self._dist()
        if dist is not None:
            res = self.refine_dist(
                dist, self.op64.vals, self.solver.op.vals,
                dist.stack_factors(self.precond._prune_factors(
                    self.precond.factors)), b)
        else:
            res = self.refine(self.op64.vals, self.solver.op.vals,
                              self.precond.apply_factors,
                              self.precond._aplans, b, sapply)
        self._last_result = res
        return res.x

    def apply_inverse(self, b):
        """Refinement solve through `Solver.apply_inverse` passes;
        returns (x, KrylovResult)."""
        b64 = torch.as_tensor(b, dtype=torch.float64, device=self.device)
        nb = float(torch.linalg.norm(b64))
        x = torch.zeros_like(b64)
        total_iters = 0
        relres = 1.0
        converged = False
        for _pass in range(self.max_passes):
            r = b64 - self.op64(x)
            relres = float(torch.linalg.norm(r)) / nb
            if relres <= self.tol:
                converged = True
                break
            d, res = self.solver.apply_inverse(r.to(torch.float32))
            total_iters += res.iters
            x = x + d.to(torch.float64)
        res = KrylovResult(x=x, iters=total_iters, relres=relres,
                           converged=converged)
        self._last_result = res
        return x, res

    @property
    def num_iter(self) -> int:
        return 0 if self._last_result is None else self._last_result.iters
