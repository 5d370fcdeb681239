"""Solver facade: Krylov method + preconditioner.

Torch counterpart of hymls_tpu/solvers/solver.py (reference
src/HYMLS_Solver.cpp:34-48, HYMLS_BaseSolver.cpp): the 'Solver' sublist
selects the Krylov method (CG, or GMRES for any other name), the
preconditioning side, the start vector and the GMRES restart length
('Num Blocks'); a border turns the solve into GMRES on the bordered
system, and `setup_deflation` turns it into the deflated solve (with a
border: deflation of the bordered system).

'Distributed Apply' runs over the active mesh: with the structured
program active, the replicated Krylov loop around the structured apply
sharded over the ranks (core/structured.py ShardedApply); else the
Krylov iteration owner-sharded (parallel/dist.py).  Every rank makes
the same calls with the same global vectors and gets the whole
solution back.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import scipy.sparse as sp

import torch

from ..config import Params
from ..core.preconditioner import Preconditioner
from ..ops.operators import product_operator, projected_operator
from ..ops.spmv import make_operator
from ..parallel.dist import make_distributed_solve
from ..parallel.halo_vcycle import UnshardableError
from ..parallel.mesh import get_mesh
from . import krylov
from . import deflation as _defl


class Solver:
    """Iterative solve of K x = b with the multilevel preconditioner."""

    def __init__(self, K: sp.csr_matrix, precond: Preconditioner,
                 params: Params, dtype=torch.float64, *, device):
        self.params = params
        self.precond = precond
        self.dtype = dtype
        self.device = torch.device(device)
        if precond.device != self.device:
            raise ValueError(f"preconditioner on {precond.device}, "
                             f"solver on {self.device}")
        self.op = make_operator(K, dtype=dtype, device=self.device)

        slist = params.sublist("Solver")
        # "CG", or GMRES for any other name, as in the reference
        self.method = slist.get("Krylov Method", "GMRES")
        # 'Random', 'Previous', or zero for any other value, as in the
        # reference
        self.start_vec = slist.get("Initial Vector", "Zero")
        self.lor = slist.get("Left or Right Preconditioning", "Left")
        it = slist.sublist("Iterative Solver")
        self.maxiter = it.get("Maximum Iterations", 100)
        self.tol = it.get("Convergence Tolerance", 1e-6)
        # Belos 'Num Blocks': GMRES basis size (restart length)
        self.restart = it.get("Num Blocks", None)
        # 'Distributed Apply' over the active mesh (the reference's
        # production multi-rank path, src/HYMLS_Preconditioner.cpp:
        # 973-1052): with the structured program active, the replicated
        # Krylov loop around the structured apply sharded over the ranks
        # (`_make_dist_structured`); else the whole Krylov iteration in
        # the owner-sharded halo layout (`_make_dist`).  Without a mesh,
        # or with a structure that cannot be owner-sharded, the first
        # solve warns and takes the replicated apply
        self.distributed = slist.get("Distributed Apply", False)
        self._dist = None
        self._dist_structured = None
        self._sapply = None
        self._last_result = None
        self._border = None
        self._border_coeffs = None
        self._deflation = None
        self._defl_aug = False
        self._opT = None
        self._K = K
        self._mass = None
        self._prev_x = None
        self._rng = np.random.default_rng(42)

    def set_matrix(self, K: sp.csr_matrix):
        """New values, same pattern (Newton-step reuse)."""
        K = K.tocsr()
        K.sum_duplicates()
        K.sort_indices()
        self.op.set_values(K.data)
        self._K = K
        if self._opT is not None:
            # keep the transpose operator (deflation) in step
            self._opT.set_values(K.T.tocsr().data)

    def set_mass_matrix(self, M: Optional[sp.spmatrix]):
        """Mass matrix for deflation and eigenvalue use (reference
        BaseSolver::SetMassMatrix): deflation then targets the dominant
        eigenmodes of P^{-1} M instead of P^{-1}."""
        self._mass = None if M is None else sp.csr_matrix(M)
        return self

    def _make_dist(self):
        """Build (once) this rank's owner-sharded operator and apply
        pair over the active mesh; returns None, with a warning and the
        option switched off, when no mesh of 2 or more ranks is active
        or the structure is unshardable."""
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
            self._dist = make_distributed_solve(self._K, self.precond,
                                                mesh)
        except UnshardableError as e:
            warnings.warn(f"'Distributed Apply' unavailable ({e}); "
                          "using the replicated apply")
            self.distributed = False
            return None
        return self._dist

    def _make_dist_structured(self):
        """The structured apply sharded over the active mesh
        (Preconditioner.sharded_sapply_fn), where the reference takes it
        (hymls_tpu/solvers/solver.py:158-184): the structured program
        active (so no border) and a mesh of 2 or more ranks.  Else None,
        and the caller goes on to `_make_dist`.  Sets `_dist_structured`
        to the mesh.

        The Krylov loop around it stays replicated: every rank holds the
        whole vectors.  Every apply ends in all_gathers, so all ranks
        get the same bytes back, and the operator, the dots and the
        preconditioner's replicated parts are deterministic functions of
        equal inputs: every host branch (convergence, breakdown, the
        refinement passes) reads equal values on every rank."""
        if not self.precond._structured_active:
            return None
        mesh = get_mesh()
        if mesh is None or mesh.size < 2:
            return None
        if self._dist_structured is not mesh:
            self._sapply = self.precond.sharded_sapply_fn(mesh)
            self._dist_structured = mesh
        return self._sapply

    def set_border(self, V, W=None, C=None):
        """Solve the bordered system [K V; W' C] [x; s] = [b; t]
        (reference BorderedSolver; used to pin a null space such as the
        constant pressure mode, and by pseudo-arclength continuation).
        W=None means W = V, C=None means 0; V=None removes the
        border."""
        self.precond.set_border(V, W, C)
        # the halo apply stacks the factors it was built with: rebuild
        # it for the bordered ones
        self._dist = None
        border = self.precond._border
        self._border = None if border is None else tuple(
            a.to(self.dtype) for a in border)
        return self

    def _start_vector(self, b):
        if self.start_vec == "Random":
            return torch.as_tensor(self._rng.standard_normal(b.shape[0]),
                                   dtype=self.dtype, device=self.device)
        if self.start_vec == "Previous" and self._prev_x is not None \
                and self._prev_x.shape == b.shape:
            # reference BaseSolver start vector 'Previous': the last
            # solution (continuation runs)
            return self._prev_x.to(self.dtype)
        return torch.zeros_like(b)

    def apply_inverse(self, b, x0: Optional[np.ndarray] = None, t=None):
        """Solve K x = b, or with a border set the bordered system with
        border right-hand side `t` (zero by default); returns
        (x, KrylovResult).  After a bordered solve the border
        coefficients s are in `_border_coeffs` (numpy).  After
        `setup_deflation` it is the deflated solve (zero start vector,
        zero border right-hand side), and the result is that of its
        projected solve."""
        if self._deflation is not None:
            bz = torch.as_tensor(b).cpu().numpy() if torch.is_tensor(b) \
                else np.asarray(b)
            if self._defl_aug:
                bz = np.concatenate([bz, np.zeros(self._border[0].shape[1])])
            x = _defl.deflated_apply(self._deflation, bz, self._proj_solve)
            return torch.as_tensor(x[:self.op.n], dtype=self.dtype,
                                   device=self.device), self._last_res
        dist = sapply = None
        if self.distributed:
            sapply = self._make_dist_structured()
            if sapply is None:
                dist = self._make_dist()
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        x0 = self._start_vector(b) if x0 is None else torch.as_tensor(
            x0, dtype=self.dtype, device=self.device)

        if dist is not None:
            res = self._solve_dist(dist, b, x0, t)
            x = res.x[:self.op.n]
            self._border_coeffs = None if self._border is None else \
                res.x[self.op.n:].cpu().numpy()
            self._last_result = res
            self._prev_x = x
            return x, res
        pvals = self.op.prepare(self.op.vals)
        fac = self.precond.factors

        if self._border is not None:
            res = self._solve_bordered(pvals, fac, b, x0, t)
            n = self.op.n
            x = res.x[:n]
            self._border_coeffs = res.x[n:].cpu().numpy()
        else:
            apply_fn = self.precond.apply_fn if sapply is None else sapply

            def op(x):
                return self.op.matvec_prepared(pvals, x)

            def prec(x):
                return apply_fn(fac, x)

            if self.method == "CG":
                res = krylov.cg(op, b, x0, prec, tol=self.tol,
                                maxiter=self.maxiter)
            else:
                res = krylov.gmres(op, b, x0, prec, tol=self.tol,
                                   maxiter=self.maxiter,
                                   left=self.lor == "Left",
                                   restart=self.restart)
            x = res.x
            self._border_coeffs = None
        self._last_result = res
        self._prev_x = x
        return x, res

    def _solve_dist(self, dist, b, x0, t=None):
        """The solve in the owner layout (reference solver.py:198-226):
        the halo matvec, the halo V-cycle on factors from the
        distributed factorization (or the replicated ones stacked), and
        the Krylov loop with its reductions over the mesh.  With a
        border, GMRES on the augmented layout (dist.make_aug): the
        x-part by halo exchange, the m-tail by one psum per operator
        apply and per level of the bordered V-cycle (reference
        src/HYMLS_BorderedSolver.cpp:173-219).  Returns the result with
        the global x ([x; s] with a border)."""
        pv = dist.prepare(self.op.vals)
        kw = dict(tol=self.tol, maxiter=self.maxiter,
                  allreduce=dist.allreduce)
        gm = dict(left=self.lor == "Left", restart=self.restart)
        if self._border is None:
            fac_st = dist.factors(self.op.vals, lambda: self.precond.factors)

            def op(x):
                return dist.matvec(pv, x)

            def prec(x):
                return dist.precond(fac_st, x)

            b_l, x0_l = dist.scatter(b), dist.scatter(x0)
            if self.method == "CG":
                res = krylov.cg(op, b_l, x0_l, prec, **kw)
            else:
                res = krylov.gmres(op, b_l, x0_l, prec, **kw, **gm)
            return res._replace(x=dist.gather(res.x))

        fac_st = dist.stack_factors(self.precond.factors.pruned)
        if "border" not in fac_st["levels"][0]:
            raise RuntimeError("the distributed bordered solve needs the "
                               "bordered factors")
        V, W, C = self._border
        m = V.shape[1]
        aug = dist.make_aug(m)
        V_l, W_l = aug.scatter_cols(V), aug.scatter_cols(W)
        if t is None:
            t = b.new_zeros(m)
        t = torch.as_tensor(t, dtype=self.dtype, device=self.device)

        def op(z):
            x_l, s = aug.split(z)
            tau = dist.allreduce(W_l.T @ x_l) + C @ s
            return aug.join(dist.matvec(pv, x_l) + V_l @ s, tau)

        def prec(z):
            x_l, tau = aug.split(z)
            return aug.join(*dist.app.apply_local_bordered(x_l, tau, fac_st))

        # GMRES, as the replicated bordered solve
        res = krylov.gmres(op, aug.scatter_aug(b, t),
                           aug.scatter_aug(x0, b.new_zeros(m)), prec,
                           **kw, **gm)
        return res._replace(x=torch.cat(aug.gather_aug(res.x)))

    def _solve_bordered(self, pvals, fac, b, x0, t):
        """GMRES on the augmented system: the operator
        [K x + V s; W' x + C s], preconditioned by the bordered
        V-cycle."""
        V, W, C = self._border
        n, m = self.op.n, V.shape[1]
        if t is None:
            t = b.new_zeros(m)
        t = torch.as_tensor(t, dtype=self.dtype, device=self.device)

        def op(z):
            x, s = z[:n], z[n:]
            return torch.cat([self.op.matvec_prepared(pvals, x) + V @ s,
                              W.T @ x + C @ s])

        def prec(z):
            return torch.cat(self.precond.apply_bordered_fn(
                fac, z[:n], z[n:]))

        return krylov.gmres(op, torch.cat([b, t]),
                            torch.cat([x0, b.new_zeros(m)]), prec,
                            tol=self.tol, maxiter=self.maxiter,
                            left=self.lor == "Left", restart=self.restart)

    # -- deflation ---------------------------------------------------------
    def setup_deflation(self, V: Optional[np.ndarray] = None):
        """Compute the deflation space and correction system (reference
        DeflatedSolver::SetupDeflation; parameter 'Deflated Subspace
        Dimension' in the 'Solver' list).  With a border set, deflation
        runs on the augmented system (the BorderedDeflatedSolver
        combination).  A dimension of 0 leaves the solver as it is.
        `V`, an orthonormal (n, k) block ((n + m, k) with a border),
        takes the place of the subspace iteration's result: the
        correction system is exact for any orthonormal V."""
        k = self.params.sublist("Solver").get(
            "Deflated Subspace Dimension", 0)
        if k <= 0:
            return self
        apply_fn, fac = self.precond.apply_fn, self.precond.factors
        self._opT = make_operator(self._K.T.tocsr(), dtype=self.dtype,
                                  device=self.device)
        n = self.op.n
        aug = self._border is not None
        m = self._border[0].shape[1] if aug else 0

        # K and K' block products on the host (scipy); a column or an
        # (n, k) block both work
        Knp = self._K.tocsr()
        if not aug:
            def mv(z):
                return Knp @ np.asarray(z)

            def mvT(z):
                return Knp.T @ np.asarray(z)
        else:
            V_b, W_b, C_b = (a.cpu().numpy() for a in self._border)

            def mv(z):
                z = np.asarray(z)
                zx, zs = z[:n], z[n:]
                return np.concatenate([Knp @ zx + V_b @ zs,
                                       W_b.T @ zx + C_b @ zs])

            def mvT(z):
                z = np.asarray(z)
                zx, zs = z[:n], z[n:]
                return np.concatenate([Knp.T @ zx + W_b @ zs,
                                       V_b.T @ zx + C_b.T @ zs])

        # the subspace iteration's block apply: the preconditioner on a
        # block of vectors, one per row, with the mass operator in front
        Mop = None
        if self._mass is not None:
            Mop = make_operator(self._mass.tocsr(), dtype=self.dtype,
                                device=self.device)
        if not aug:
            def vcycle(Z):
                return apply_fn(fac, Z)
            apply_block = vcycle if Mop is None else \
                product_operator(vcycle, Mop)
        else:
            def apply_block(Z):
                zx, zs = Z[:, :n].contiguous(), Z[:, n:]
                if Mop is not None:
                    zx = Mop(zx)
                return torch.cat(self.precond.apply_bordered_fn(
                    fac, zx, zs), dim=1)

        self._defl_info = {}
        if V is None:
            V = _defl.compute_deflation_space_device(
                apply_block, n + m, k, self.dtype, device=self.device,
                _info=self._defl_info)
        Vt = torch.as_tensor(V, dtype=self.dtype, device=self.device)
        solve, solve_setup = self._build_proj_solve(aug)

        def as_t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                                   device=self.device)

        def proj_solve(r):
            res = solve(fac, Vt, as_t(r))
            self._last_res = res
            return res.x.cpu().numpy()

        def multi_solve(Rhs):
            """The k projected setup columns in one batched GMRES (the
            JAX package's `jax.vmap` of the solve); the result kept is
            the last column's.  Replicated also under 'Distributed
            Apply', as in the reference: the setup runs once, the
            projected solves per right-hand side are the hot path."""
            res = solve_setup(fac, Vt, as_t(Rhs.T))
            self._last_res = krylov.KrylovResult(
                x=res.x[-1], iters=int(res.iters[-1]),
                relres=float(res.relres[-1]),
                converged=bool(res.converged[-1]))
            return res.x.T.cpu().numpy()

        self._deflation = _defl.setup_deflation(V, mv, mvT, proj_solve,
                                                multi_solve=multi_solve)
        self._proj_solve = proj_solve
        self._defl_aug = aug
        return self

    def _build_proj_solve(self, aug: bool = False):
        """(solve, solve_setup), each solve(fac, V, b):
        GMRES from a zero start vector on the projected system
        (I - VV') A (I - VV'), preconditioned by the projected V-cycle;
        with `aug` on the bordered system.  A block b (B, n) of
        right-hand sides, one per row, is one batched GMRES
        (`krylov.gmres_batched`) whose operator and V-cycle take the
        whole block.  Under 'Distributed Apply' (not bordered) `solve`
        runs owner-sharded and `solve_setup` replicated."""
        tol, maxiter = self.tol, self.maxiter
        left = self.lor == "Left"
        n = self.op.n
        dist = self._make_dist() if self.distributed and not aug else None

        def run(op, prec, b, **kw):
            gm = krylov.gmres_batched if b.dim() == 2 else krylov.gmres
            return gm(op, b, torch.zeros_like(b), prec, tol=tol,
                      maxiter=maxiter, left=left, **kw)

        if not aug:
            apply_fn = self.precond.apply_fn

            def solve(fac, V, b):
                pvals = self.op.prepare(self.op.vals)
                return run(
                    projected_operator(
                        lambda x: self.op.matvec_prepared(pvals, x), V),
                    projected_operator(lambda x: apply_fn(fac, x), V), b)
            if dist is None:
                return solve, solve

            def solve_dist(fac, V, b):
                """The deflated iteration owner-sharded (reference solver
                .py:451-482): V scattered into the owner layout, the
                projector's V'x one psum (reference ProjectedOperator
                over distributed multivectors,
                src/HYMLS_DeflatedSolver.cpp:159-245)."""
                pv = dist.prepare(self.op.vals)
                fac_st = dist.stack_factors(self.precond.factors.pruned)
                V_l = dist.scatter_cols(V)

                def proj(x):
                    return x - V_l @ dist.allreduce(V_l.T @ x)

                def op(x):
                    return proj(dist.matvec(pv, proj(x)))

                def prec(x):
                    return proj(dist.precond(fac_st, proj(x)))

                res = run(op, prec, dist.scatter(b),
                          allreduce=dist.allreduce)
                return res._replace(x=dist.gather(res.x))
            return solve_dist, solve

        bord_fn = self.precond.apply_bordered_fn

        def solve(fac, V, b):
            Vb, Wb, Cb = self._border
            pvals = self.op.prepare(self.op.vals)

            def op(z):
                if z.dim() == 2:
                    x, sb = z[:, :n].contiguous(), z[:, n:]
                    return torch.cat([
                        self.op.matvec_prepared(pvals, x) + sb @ Vb.T,
                        x @ Wb + sb @ Cb.T], dim=1)
                x, sb = z[:n], z[n:]
                return torch.cat([
                    self.op.matvec_prepared(pvals, x) + Vb @ sb,
                    Wb.T @ x + Cb @ sb])

            def prec(z):
                return torch.cat(bord_fn(fac, z[..., :n], z[..., n:]),
                                 dim=-1)

            return run(projected_operator(op, V),
                       projected_operator(prec, V), b)
        return solve, solve

    @property
    def num_iter(self) -> int:
        return 0 if self._last_result is None else self._last_result.iters
