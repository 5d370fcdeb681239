"""A linear solve and its judge, in plain SciPy.

`relres` is the judge: the true relative residual ||b - K x|| / ||b||,
in float64, of a solution x of K x = b, the quantity the configuration's
convergence tolerance bounds.  `solve` is the reference solve (SuperLU, a
direct sparse LU), which in float32 is the lower-precision control.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def matrix(indptr, indices, data, n: int) -> sp.csr_matrix:
    """The CSR matrix of a pattern and its values, in float64."""
    return sp.csr_matrix((np.asarray(data, dtype=np.float64), indices,
                          indptr), shape=(n, n))


def relres(K: sp.csr_matrix, x, b) -> float:
    """||b - K x||_2 / ||b||_2 in float64; inf for a non-finite x."""
    x = np.asarray(x, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if not np.isfinite(x).all():
        return float("inf")
    return float(np.linalg.norm(b - K @ x) / np.linalg.norm(b))


def factor(K: sp.csr_matrix, dtype=np.float64):
    """The solve b -> x with K x = b by SuperLU, factored and solved in
    `dtype`, x returned in float64."""
    lu = spla.splu(K.astype(dtype).tocsc())
    return lambda b: lu.solve(np.asarray(b, dtype=dtype)).astype(np.float64)


def solve(K: sp.csr_matrix, b, dtype=np.float64) -> np.ndarray:
    """x with K x = b by SuperLU, factor and solve in `dtype`."""
    return factor(K, dtype)(b)
