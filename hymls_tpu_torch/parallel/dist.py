"""Distributed Krylov solve: owner-sharded vectors end to end.

Torch counterpart of hymls_tpu/parallel/dist.py (reference: every Krylov
iteration communicates through Epetra_Import halo exchanges,
src/HYMLS_Preconditioner.cpp:973-1052, src/HYMLS_BaseSolver.cpp:
309-359).  The Krylov state of each rank is its owner-layout vector of
the halo V-cycle (parallel/halo_vcycle.py): (L,), the interior nodes of
its subdomains plus the separators it owns, zero-padded.  In that
layout

  * the preconditioner apply is the neighbour-halo V-cycle;
  * the operator apply K x is a per-rank ELL SpMV whose off-rank
    columns arrive by the same static-plan ppermute exchange (built
    here by `build_matvec_plan`, a numpy copy of the reference's);
  * dots and norms are rank-local sums completed by one `psum`: the
    solvers pass `DistributedSolve.allreduce` to solvers/krylov.py.

Nothing on the iteration path gathers the global vector: the only
all_gathers are the coarse right-hand side (one per V-cycle) and the
final read-out of the solution.

API contract: every rank builds the same Preconditioner from the same
global inputs and calls the same methods with the same global vectors;
`gather` gives every rank the whole solution.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp

import torch

from .halo_vcycle import (UnshardableError, _Exchange,
                          _build_exchange, _finalize_sends,
                          _recv_offsets_table, _cat0, make_halo_apply,
                          rank_slice)
from . import collectives as C


def build_matvec_plan(K: sp.csr_matrix, gather_idx: np.ndarray,
                      L: int, ndev: int):
    """Static per-shard ELL + halo-exchange plan for y = K x in the
    owner layout.

    gather_idx[n] = owner(n) * L + local_slot(n) (from
    build_halo_plans' level-0 boundary maps).  Returns (plan_arrays,
    meta) where plan_arrays hold, per shard: the ELL column positions
    into [x_local ++ recv buffers ++ zero], the value-gather indices
    into the global CSR data array, and the ppermute send lists."""
    K = K.tocsr()
    K.sum_duplicates()
    K.sort_indices()
    n = K.shape[0]
    nnz = K.nnz
    own = gather_idx // L
    loc = gather_idx % L
    lens = np.diff(K.indptr)
    width = int(lens.max()) if nnz else 1
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    slots = np.arange(nnz, dtype=np.int64) - np.repeat(K.indptr[:-1],
                                                       lens)
    cols = K.indices.astype(np.int64)
    dsh = own[rows]                      # shard that computes the row
    ssh = own[cols]                      # shard that owns the column

    # one halo entry per distinct (column, needing shard) pair
    rem = np.nonzero(dsh != ssh)[0]
    if rem.size:
        pairs = np.unique(np.stack([cols[rem], dsh[rem]], axis=1),
                          axis=0)
        p_col, p_dst = pairs[:, 0], pairs[:, 1]
        ex, pos = _build_exchange(ndev, own[p_col], p_dst,
                                  loc[p_col], p_col)
    else:
        p_col = p_dst = np.zeros(0, dtype=np.int64)
        ex, pos = _Exchange(), {}
    _finalize_sends(ex, L)               # sender zero slot = cat0 tail
    rtab, zslot = _recv_offsets_table(ex, L)
    read_of = {}
    for i in range(p_col.size):
        d, rank = pos[int(i)]
        read_of[(int(p_col[i]), int(p_dst[i]))] = rtab[d] + rank

    colpos = np.empty(nnz, dtype=np.int64)
    loc_mask = dsh == ssh
    colpos[loc_mask] = loc[cols[loc_mask]]
    if rem.size:
        colpos[rem] = [read_of[(int(c), int(d))]
                       for c, d in zip(cols[rem], dsh[rem])]

    colidx = np.full((ndev, L, width), zslot, dtype=np.int64)
    vidx = np.full((ndev, L, width), nnz, dtype=np.int64)
    colidx[dsh, loc[rows], slots] = colpos
    vidx[dsh, loc[rows], slots] = np.arange(nnz)

    plan = {"mv_col": colidx, "mv_vidx": vidx}
    for d in ex.offsets:
        plan[f"mv_send_{d}"] = ex.send_idx[d]
    meta = {"offsets": ex.offsets, "width": width, "L": L}
    return plan, meta


class _EllExchange:
    """One operator's per-rank ELL block and exchange plan."""

    def __init__(self, plan, meta, mesh, tag):
        self.mesh = mesh
        self.offsets = meta["offsets"]
        self.width = meta["width"]
        self.tag = tag
        self.plan = rank_slice(plan, mesh.rank, mesh.device)

    def prepare(self, vals):
        """CSR values (replicated) -> this rank's (L, width) ELL values."""
        vals = torch.as_tensor(vals, device=self.mesh.device)
        return _cat0(vals)[self.plan["mv_vidx"]]

    def matvec(self, pvals, x_l):
        """y = K x in the owner layout; x_l real or complex."""
        x0 = _cat0(x_l)
        recvs = [C.shift(self.mesh, x0[self.plan[f"mv_send_{d}"]], d,
                         tag=self.tag) for d in self.offsets]
        x_ext = _cat0(x_l, *recvs)
        return torch.sum(pvals * x_ext[self.plan["mv_col"]], dim=1)


class DistributedSolve:
    """This rank's owner-sharded operator and preconditioner pair for a
    distributed Krylov solve over `mesh`:

      scatter(b)            global (n,) -> owner layout (L,)
      gather(x_l)           owner layout of all ranks -> global (n,)
      prepare(vals)         CSR values -> per-rank ELL values
      matvec(pvals, x_l)    y = K x, ppermute halo exchange
      precond(factors, x_l) halo V-cycle apply
      stack_factors(f)      pruned generic factors -> halo layout
      factors(vals, rep)    halo-layout factors of vals: dcompute's,
                            else the replicated rep().pruned stacked
      allreduce(x)          psum, the Krylov solvers' reduction hook
    """

    def __init__(self, K: sp.csr_matrix, precond, mesh):
        self.mesh = mesh
        ndev = mesh.size
        if getattr(precond, "_bgrid", None) is not None:
            # the preconditioner holds M = T'KT and conjugates its apply
            # with T; the owner-layout operator and factorization here
            # would read K's values through M's plans (the reference
            # does, and its distributed B-grid solve returns NaN)
            raise UnshardableError("the B-grid transform is not "
                                   "distributed")
        self.app = make_halo_apply(precond, mesh)
        # the distributed factorization, where the structure allows it
        # (the whole Newton step then runs sharded); otherwise the
        # replicated factors are stacked (stack_factors)
        try:
            from .dist_compute import DistributedCompute
            self.dcompute = DistributedCompute(precond, mesh)
        except UnshardableError:
            self.dcompute = None
        bm = self.app._bmaps
        self.L = bm["max_onod0"]
        self.n = bm["n_nodes"]
        self._gidx = np.asarray(bm["gather_idx"], dtype=np.int64)
        plan, meta = build_matvec_plan(K, self._gidx, self.L, ndev)
        self._mv = _EllExchange(plan, meta, mesh, "mv")

    def make_extra_matvec(self, K2: sp.csr_matrix):
        """Owner-layout SpMV of a second operator on the same grid (the
        B of a complex pencil A + iB, or a mass matrix): its own ELL and
        exchange plan over the same ownership.  Returns (prepare,
        matvec) (reference: ComplexOperator applies A and B as
        independent distributed operators,
        src/HYMLS_ComplexOperator.cpp)."""
        if K2.shape[0] != self.n:
            raise ValueError(
                f"extra operator size {K2.shape[0]} != grid {self.n}")
        plan, meta = build_matvec_plan(K2.tocsr(), self._gidx, self.L,
                                       self.mesh.size)
        ex = _EllExchange(plan, meta, self.mesh, "mv_extra")
        return ex.prepare, ex.matvec

    # -- building blocks ------------------------------------------------------
    def scatter(self, b):
        return self.app.to_local(b)

    def gather(self, x_l):
        return self.app.to_global(x_l)

    def scatter_cols(self, V):
        """(n, m) columns -> (L, m) owner layout."""
        V = torch.as_tensor(V, device=self.mesh.device)
        return torch.cat([V, V.new_zeros((1, V.shape[1]))])[
            self.app._scatter]

    def prepare(self, vals):
        return self._mv.prepare(vals)

    def matvec(self, pvals, x_l):
        return self._mv.matvec(pvals, x_l)

    def precond(self, factors_st, x_l):
        return self.app.apply_local(x_l, factors_st)

    def stack_factors(self, factors):
        return self.app.stack_factors(factors)

    def factors(self, vals, replicated):
        """This rank's halo-layout factors of the values `vals`: the
        distributed factorization where the structure allows it
        (dcompute), else the pruned view of the replicated `Factors`
        that `replicated()` gives, stacked."""
        if self.dcompute is not None:
            return self.dcompute.compute(vals)
        return self.stack_factors(replicated().pruned)

    def allreduce(self, x):
        return C.psum(self.mesh, x)

    def norm(self, x_l):
        """The global 2-norm of an owner-layout vector."""
        return torch.sqrt(self.allreduce(torch.sum((x_l.conj() * x_l).real)))

    # -- the bordered (augmented) layout --------------------------------------
    # The bordered system [K V; W' C] iterates on per-rank vectors
    # [x_l (L), s / sqrt(ndev) (m)]: every rank holds the tail scaled by
    # 1/sqrt(ndev), so the global norm and dot of the augmented vector
    # are the rank sums (||z||^2 = ||x||^2 + ndev ||s||^2 / ndev) and
    # the unmodified Krylov loops run the bordered iteration (reference
    # BorderedVector MultiVecTraits, src/HYMLS_BorderedVector.hpp:23-80).
    def make_aug(self, m: int):
        """split/join/scatter helpers for an m-column border."""
        L = self.L
        sq = math.sqrt(self.mesh.size)
        dist = self

        class _Aug:
            @staticmethod
            def split(z):
                """z_l -> (x_l (L,), s (m,)); the tails are the same on
                every rank."""
                return z[:L], z[L:] * sq

            @staticmethod
            def join(x_l, s):
                return torch.cat([x_l, s / sq])

            @staticmethod
            def scatter_aug(b, t):
                return _Aug.join(dist.scatter(b), t)

            @staticmethod
            def gather_aug(z):
                x_l, s = _Aug.split(z)
                return dist.gather(x_l), s

            scatter_cols = staticmethod(dist.scatter_cols)

        return _Aug


def make_distributed_solve(K, precond, mesh) -> DistributedSolve:
    """This rank's distributed operator and preconditioner pair; raises
    UnshardableError when the group structure cannot be owner-sharded
    over this mesh (callers take the replicated apply)."""
    return DistributedSolve(K, precond, mesh)
