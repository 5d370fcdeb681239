"""Runtime invariant checks ("in-situ sanitizers").

Behavioral equivalent of the reference's Tester predicates
(reference src/HYMLS_Tester.{hpp,cpp}, invoked via the HYMLS_TEST macro
in debug builds): structural properties of operators and of the
decomposition that the method's correctness relies on.  Called from the
test suite (and optionally from Preconditioner.initialize with
check_invariants=True).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

FLOAT_TOL = 1e-10


def is_symmetric_graph(A: sp.csr_matrix) -> bool:
    """Structural symmetry of the sparsity pattern."""
    B = A.copy()
    B.data = np.ones_like(B.data)
    return (B != B.T).nnz == 0


def is_fmatrix(A: sp.csr_matrix, dof: int, pvar: int,
               tol: float = FLOAT_TOL) -> bool:
    """F-matrix check (reference Tester::isFmatrix): structurally
    symmetric pattern; every non-pressure row has at most 2 pressure
    couplings whose sum is ~0; pressure diagonal zero-free checks are
    left to the solver."""
    if not is_symmetric_graph(A):
        return False
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    is_p_row = rows % dof == pvar
    is_p_col = cols % dof == pvar
    m = (~is_p_row) & is_p_col
    # per-row count and sum of pressure couplings
    cnt = np.bincount(rows[m], minlength=n)
    s = np.bincount(rows[m], weights=A.data[m], minlength=n)
    if cnt.max(initial=0) > 2:
        return False
    if np.abs(s).max(initial=0.0) > tol:
        return False
    return True


def is_dd_correct(A: sp.csr_matrix, hierarchy) -> bool:
    """Domain-decomposition correctness (reference Tester::isDDcorrect):
    no couplings between interior nodes of different subdomains."""
    n = A.shape[0]
    owner = np.full(n, -1, dtype=np.int64)
    for sd, nodes in enumerate(hierarchy.interior):
        owner[nodes] = sd
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    m = (owner[rows] >= 0) & (owner[cols] >= 0) & (A.data != 0)
    return bool(np.all(owner[rows[m]] == owner[cols[m]]))


def is_div_free(A: sp.csr_matrix, X: np.ndarray, dof: int, pvar: int,
                tol: float = 1e-8) -> bool:
    """P-rows of A @ X are ~0 (reference Tester::isDivFree)."""
    Y = A @ X
    if Y.ndim == 1:
        Y = Y[:, None]
    pm = (np.arange(A.shape[0]) % dof) == pvar
    return bool(np.abs(Y[pm]).max(initial=0.0) <= tol)


def no_numerical_zeros(A: sp.csr_matrix) -> bool:
    """No stored entries below machine epsilon except on the diagonal
    (reference Tester::noNumericalZeros)."""
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    off = rows != A.indices
    return not np.any(np.abs(A.data[off]) <= np.finfo(float).eps)


def no_p_couplings_dropped(sc_vals: np.ndarray, plan, hierarchy,
                           dof: int, pvar: int,
                           tol: float = FLOAT_TOL) -> bool:
    """After transform-and-drop, non-Vsum rows must not couple to any
    pressure column (reference Tester::noPcouplingsDropped)."""
    # the kept pattern has non-Vsum rows coupling only within their
    # linked block; check those blocks contain no pressure columns
    for lset in hierarchy.linked_sets:
        nodes = []
        for gi in lset:
            g = hierarchy.groups[gi]
            nodes.extend(g.nodes[1:].tolist())
        for a in nodes:
            if a % dof == pvar:
                return False
    return True
