"""Bytes a kernel needs for one launch, counted from the shapes the
benchmark made: each input read once and each output written once."""
from __future__ import annotations


def k1_bytes(n: int, bands: int, itemsize: int) -> int:
    """K1, the DIA SpMV y = A x: bands x n values, the bands' int32
    offsets, x and y, at the launch's value size."""
    return bands * n * itemsize + 4 * bands + 2 * n * itemsize


def dia_bands(indptr, indices) -> int:
    """Number of distinct diagonals of a CSR pattern: the bands a DIA
    operator of it holds."""
    import numpy as np
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return int(np.unique(np.asarray(indices) - rows).size)
