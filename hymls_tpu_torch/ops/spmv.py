"""Sparse matrix-vector products for structured stencil matrices.

Torch counterpart of hymls_tpu/ops/spmv.py.  The matrix is converted
once on the host into a static layout with a gather map from the CSR
value array, so Newton-step value updates need no re-indexing:

  * DIA (at most 48 distinct column offsets, i.e. every stencil
    matrix): bands (k, n) times shifted copies of x — on CUDA one
    launch of the hand-written kernel (ops/dia_spmv.py);
  * ELL otherwise: a (n, width) gather + multiply + row sum.

Both take a vector (n,) or a block (B, n) of B vectors, one per row
(the JAX package's `jax.vmap` of `matvec_prepared`): a DIA block is one
launch of the multi-column kernel, an ELL block one batched gather.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

import torch

from .dia_spmv import DiaOffsets, dia_matmat_packed, dia_matvec_packed


def _canonical(A: sp.spmatrix) -> sp.csr_matrix:
    A = A.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


class EllOperator:
    """y = A @ x with A in padded row-major ELL form."""

    def __init__(self, A: sp.csr_matrix, dtype=torch.float64, *, device):
        A = _canonical(A)
        n = A.shape[0]
        width = int(np.diff(A.indptr).max()) if A.nnz else 1
        cols = np.full((n, width), n, dtype=np.int64)
        vidx = np.full((n, width), A.nnz, dtype=np.int64)
        lens = np.diff(A.indptr)
        rowrep = np.repeat(np.arange(n), lens)
        offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], lens)
        cols[rowrep, offs] = A.indices
        vidx[rowrep, offs] = np.arange(A.nnz)
        self.n = n
        self.nnz = A.nnz
        self.width = width
        self.dtype = dtype
        self.device = torch.device(device)
        self.cols = torch.as_tensor(cols, device=self.device)
        self.vidx = torch.as_tensor(vidx, device=self.device)
        self.vals = torch.as_tensor(A.data, dtype=dtype, device=self.device)

    def set_values(self, vals):
        self.vals = torch.as_tensor(vals, dtype=self.dtype, device=self.device)

    def prepare(self, vals):
        vals_ext = torch.cat([vals, vals.new_zeros(1)])
        return vals_ext[self.vidx]

    def matvec_prepared(self, pvals, x):
        if x.dim() == 2:
            x_ext = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
            return torch.sum(pvals * x_ext[:, self.cols], dim=2)
        x_ext = torch.cat([x, x.new_zeros(1)])
        return torch.sum(pvals * x_ext[self.cols], dim=1)

    def matvec_with(self, vals, x):
        return self.matvec_prepared(self.prepare(vals), x)

    def __call__(self, x):
        return self.matvec_with(self.vals, x)


class DiaOperator(torch.nn.Module):
    """Offset-diagonal (DIA) SpMV for stencil matrices.

    Band k, row i holds A[i, i + offsets[k]].  The buffers are the band
    gather map `vidx` (k, n) into the CSR value array (the nnz slot is
    the zero sentinel) and the values `vals`; `prepare(vals)` gathers
    the (k, n) contiguous bands once per value set, and
    `matvec_prepared(bands, x)` is one `dia_matvec_packed` call on the
    offsets packed at construction (`packed`), or for a block x (B, n)
    one `dia_matmat_packed` call."""

    def __init__(self, A: sp.csr_matrix, dtype=torch.float64, *, device):
        super().__init__()
        A = _canonical(A)
        n = A.shape[0]
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
        offs = A.indices.astype(np.int64) - rows
        uniq = np.unique(offs)
        off_of = np.searchsorted(uniq, offs)
        vidx = np.full((uniq.size, n), A.nnz, dtype=np.int64)
        vidx[off_of, rows] = np.arange(A.nnz)
        self.offsets: Tuple[int, ...] = tuple(int(o) for o in uniq)
        self.packed = DiaOffsets(self.offsets)
        self.n = n
        self.nnz = A.nnz
        self.dtype = dtype
        device = torch.device(device)
        self.register_buffer("vidx", torch.as_tensor(vidx, device=device))
        self.register_buffer("vals", torch.as_tensor(A.data, dtype=dtype,
                                                     device=device))

    @property
    def device(self) -> torch.device:
        return self.vidx.device

    def set_values(self, vals):
        self.vals = torch.as_tensor(vals, dtype=self.dtype, device=self.device)

    def prepare(self, vals):
        """Band extraction, hoisted out of iteration loops."""
        vals_ext = torch.cat([vals, vals.new_zeros(1)])
        return vals_ext[self.vidx]                   # (k, n) contiguous

    def matvec_prepared(self, bands, x):
        if x.dim() == 2:
            return dia_matmat_packed(bands, x, self.packed)
        return dia_matvec_packed(bands, x, self.packed)

    def matvec_with(self, vals, x):
        return self.matvec_prepared(self.prepare(vals), x)

    def forward(self, x):
        return self.matvec_with(self.vals, x)


def make_operator(A: sp.csr_matrix, dtype=torch.float64, max_bands: int = 48,
                  *, device):
    """DIA for stencil-like matrices, ELL otherwise."""
    A = A.tocsr()
    n = A.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    n_offsets = np.unique(A.indices.astype(np.int64) - rows).size
    if n_offsets <= max_bands:
        return DiaOperator(A, dtype=dtype, device=device)
    return EllOperator(A, dtype=dtype, device=device)
