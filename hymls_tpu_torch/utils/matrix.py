"""Host-side sparse-matrix utilities (reference HYMLS::MatrixUtils,
src/HYMLS_MatrixUtils.{hpp,cpp}).

These operate on scipy CSR matrices during the symbolic/setup phase;
the device-side numeric analogues (value-zeroing on a static pattern)
live in core/preconditioner.py, because TPU programs need static
sparsity patterns.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

#: reference HYMLS_SMALL_ENTRY (src/HYMLS_Macros.hpp:26-30)
SMALL_ENTRY = 1e-14

#: the seven drop modes of MatrixUtils::DropByValue
#: (src/HYMLS_MatrixUtils.hpp:51-65)
DROP_MODES = ("Absolute", "AbsZeroDiag", "AbsFullDiag",
              "Relative", "RelDropDiag", "RelZeroDiag", "RelFullDiag")


def drop_by_value(A: sp.spmatrix, threshold: float = SMALL_ENTRY,
                  mode: str = "RelZeroDiag") -> sp.csr_matrix:
    """Drop small entries from A (reference MatrixUtils::DropByValue,
    src/HYMLS_MatrixUtils.hpp:202-207 and the DropType enum at
    hpp:51-65).

    Modes (aij = off-diagonal, aii = diagonal):

    * ``Absolute``:    drop aij if \\|aij\\| <= tol; same rule on aii.
    * ``AbsZeroDiag``: like Absolute but small aii are kept as
      explicit 0.0 instead of removed from the pattern.
    * ``AbsFullDiag``: like AbsZeroDiag, and every row gets an
      explicit diagonal entry even if it had none.
    * ``Relative``:    drop aij if \\|aij\\| <= tol*max(\\|aii\\|,\\|ajj\\|)
      (symmetric criterion, F-matrix safe); diagonal never dropped.
    * ``RelDropDiag``: Relative off-diagonal rule; absolute rule on
      the diagonal (delete aii if \\|aii\\| <= tol).
    * ``RelZeroDiag``: like RelDropDiag but aii becomes explicit 0.0.
    * ``RelFullDiag``: like RelZeroDiag plus an explicit diagonal
      entry in every row (the mode the coarse solver uses).
    """
    if mode not in DROP_MODES:
        raise ValueError(f"unknown drop mode {mode!r}; one of {DROP_MODES}")
    A = A.tocoo()
    n = A.shape[0]
    rows, cols, vals = A.row, A.col, A.data
    absv = np.abs(vals)
    is_diag = rows == cols

    diag = np.zeros(n, dtype=vals.dtype)
    diag[rows[is_diag]] = vals[is_diag]
    adiag = np.abs(diag)

    if mode in ("Absolute", "AbsZeroDiag", "AbsFullDiag"):
        keep_off = absv > threshold
        diag_small = adiag <= threshold
    else:
        keep_off = absv > threshold * np.maximum(adiag[rows], adiag[cols])
        diag_small = adiag <= threshold

    keep = np.where(is_diag, True, keep_off)
    if mode in ("Absolute", "RelDropDiag"):
        keep &= ~(is_diag & diag_small[rows])
    elif mode == "Relative":
        pass  # diagonal never touched
    else:  # *ZeroDiag / *FullDiag: keep entry, zero its value
        vals = np.where(is_diag & diag_small[rows], 0.0, vals)

    B = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=A.shape)
    if mode in ("AbsFullDiag", "RelFullDiag"):
        # force an explicit (possibly zero) diagonal in every row
        have = np.zeros(n, dtype=bool)
        bc = B.tocoo()
        have[bc.row[bc.row == bc.col]] = True
        missing = np.where(~have)[0]
        if missing.size:
            # concat explicit zeros (scipy's + would prune them)
            B = sp.csr_matrix(
                (np.concatenate([bc.data, np.zeros(missing.size)]),
                 (np.concatenate([bc.row, missing]),
                  np.concatenate([bc.col, missing]))), shape=A.shape)
    B.sum_duplicates()
    B.sort_indices()
    return B


def put_dirichlet(A: sp.csr_matrix, gids, factor: float = 1.0,
                  symmetric: bool = True) -> sp.csr_matrix:
    """Replace the rows (and, if symmetric, columns) of `gids` by
    factor*identity (reference MatrixUtils::PutDirichlet, used by the
    coarse solver to pin pressure GIDs,
    src/HYMLS_CoarseSolver.cpp:141-152)."""
    A = A.tolil(copy=True)
    gids = np.atleast_1d(np.asarray(gids, dtype=np.int64))
    for g in gids:
        A.rows[g] = [int(g)]
        A.data[g] = [factor]
    A = A.tocsr()
    if symmetric:
        A = A.T.tolil()
        for g in gids:
            A.rows[g] = [int(g)]
            A.data[g] = [factor]
        A = A.tocsr().T.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A
