"""Native (C++) runtime components, built on demand with g++.

The reference's runtime layer (IO, symbolic setup) is native C++;
these modules provide the equivalents here.  Everything has a pure
Python fallback, so the package works without a compiler.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[str]:
    src = os.path.join(_HERE, "mmio.cpp")
    so = os.path.join(_HERE, "_mmio.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", so, src],
                       check=True, capture_output=True, timeout=120)
        return so
    except Exception:
        return None


def lib() -> Optional[ctypes.CDLL]:
    """The native library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is None and not _TRIED:
            _TRIED = True
            so = _build()
            if so:
                L = ctypes.CDLL(so)
                L.mm_count.restype = ctypes.c_int
                L.mm_count.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_long),
                    ctypes.POINTER(ctypes.c_long),
                    ctypes.POINTER(ctypes.c_long),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                ]
                L.mm_read.restype = ctypes.c_long
                L.mm_read.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_long,
                ]
                L.mm_read_array.restype = ctypes.c_long
                L.mm_read_array.argtypes = [
                    ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
                ]
                _LIB = L
        return _LIB


def read_matrix_market(path: str):
    """(csr_matrix | dense ndarray) via the native reader, or None if
    the native library is unavailable / format unsupported."""
    import numpy as np
    import scipy.sparse as sp

    L = lib()
    if L is None:
        return None
    n_rows = ctypes.c_long()
    n_cols = ctypes.c_long()
    nnz = ctypes.c_long()
    symm = ctypes.c_int()
    patt = ctypes.c_int()
    ret = L.mm_count(path.encode(), ctypes.byref(n_rows),
                     ctypes.byref(n_cols), ctypes.byref(nnz),
                     ctypes.byref(symm), ctypes.byref(patt))
    if ret == 1:
        vals = np.empty(n_rows.value * n_cols.value, dtype=np.float64)
        got = L.mm_read_array(path.encode(),
                              vals.ctypes.data_as(ctypes.c_void_p),
                              vals.size)
        if got != vals.size:
            return None
        return vals.reshape((n_cols.value, n_rows.value)).T
    if ret != 0:
        return None
    m = nnz.value
    rows = np.empty(m, dtype=np.int64)
    cols = np.empty(m, dtype=np.int64)
    vals = np.empty(m, dtype=np.float64)
    got = L.mm_read(path.encode(),
                    rows.ctypes.data_as(ctypes.c_void_p),
                    cols.ctypes.data_as(ctypes.c_void_p),
                    vals.ctypes.data_as(ctypes.c_void_p), m)
    if got != m:
        return None
    if symm.value:
        off = rows != cols
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, rows[:m][off]])
        vals = np.concatenate([vals, vals[off]])
    A = sp.coo_matrix((vals, (rows, cols)),
                      shape=(n_rows.value, n_cols.value)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


# ---------------------------------------------------------------------------
# native plan-builder core (planner.cpp)
# ---------------------------------------------------------------------------

_PLANNER: Optional[ctypes.CDLL] = None
_PLANNER_TRIED = False


def planner() -> Optional[ctypes.CDLL]:
    """The native plan-builder library, or None."""
    global _PLANNER, _PLANNER_TRIED
    with _LOCK:
        if _PLANNER is None and not _PLANNER_TRIED:
            _PLANNER_TRIED = True
            src = os.path.join(_HERE, "planner.cpp")
            so = os.path.join(_HERE, "_planner.so")
            try:
                if not (os.path.exists(so) and
                        os.path.getmtime(so) >= os.path.getmtime(src)):
                    subprocess.run(
                        ["g++", "-O3", "-pthread", "-shared", "-fPIC",
                         "-o", so, src],
                        check=True, capture_output=True, timeout=120)
                L = ctypes.CDLL(so)
                c_i64p = ctypes.POINTER(ctypes.c_int64)
                L.lookup_sorted_i64.restype = None
                L.lookup_sorted_i64.argtypes = [
                    c_i64p, ctypes.c_int64, c_i64p, ctypes.c_int64,
                    ctypes.c_int64, c_i64p]
                L.invert_to_padded_i64.restype = ctypes.c_int64
                L.invert_to_padded_i64.argtypes = [
                    c_i64p, c_i64p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, c_i64p]
                L.locate_sorted_i64.restype = None
                L.locate_sorted_i64.argtypes = [
                    c_i64p, ctypes.c_int64, c_i64p, ctypes.c_int64, c_i64p]
                L.csr_hash_build_i64.restype = ctypes.c_void_p
                L.csr_hash_build_i64.argtypes = [c_i64p, ctypes.c_int64]
                L.csr_hash_free_i64.restype = None
                L.csr_hash_free_i64.argtypes = [ctypes.c_void_p]
                L.csr_hash_lookup_i64.restype = None
                L.csr_hash_lookup_i64.argtypes = [
                    ctypes.c_void_p, c_i64p, ctypes.c_int64,
                    ctypes.c_int64, c_i64p]
                L.csr_hash_block_i64.restype = None
                L.csr_hash_block_i64.argtypes = [
                    ctypes.c_void_p, c_i64p, c_i64p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    c_i64p]
                _PLANNER = L
            except Exception:
                _PLANNER = None
        return _PLANNER


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def lookup_sorted(keys, queries, miss: int):
    """Native batched sorted lookup; None if unavailable."""
    import numpy as np
    L = planner()
    if L is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    q = np.ascontiguousarray(queries, dtype=np.int64)
    out = np.empty(q.shape, dtype=np.int64)
    L.lookup_sorted_i64(_i64p(keys), keys.size, _i64p(q.reshape(-1)),
                        q.size, miss, _i64p(out.reshape(-1)))
    return out


class CsrHash:
    """Owned handle to a native open-addressing hash over the sorted
    CSR entry keys: O(1) (row, col) -> entry-id queries replacing the
    O(log nnz), ~20-cache-miss binary search (the plan builder issues
    ~1e8 of them per level at 32^3-skew sizes on a 1-core host).
    None-safe: use `CsrHash.build(keys)` which returns None when the
    native library is unavailable."""

    __slots__ = ("_handle",)

    def __init__(self, handle):
        self._handle = handle

    @staticmethod
    def build(keys) -> "Optional[CsrHash]":
        import numpy as np
        L = planner()
        if L is None:
            return None
        k = np.ascontiguousarray(keys, dtype=np.int64)
        if k.size and int(k.min()) < 0:
            return None     # -1 is the empty-slot sentinel
        return CsrHash(L.csr_hash_build_i64(_i64p(k), k.size))

    def __del__(self):
        try:
            if self._handle and _PLANNER is not None:
                _PLANNER.csr_hash_free_i64(self._handle)
        except Exception:
            pass

    def lookup(self, queries, miss: int):
        import numpy as np
        q = np.ascontiguousarray(queries, dtype=np.int64)
        out = np.empty(q.shape, dtype=np.int64)
        _PLANNER.csr_hash_lookup_i64(self._handle, _i64p(q.reshape(-1)),
                                     q.size, miss, _i64p(out.reshape(-1)))
        return out

    def lookup_block(self, rows, cols, stride: int, miss: int,
                     row_limit: Optional[int] = None,
                     col_limit: Optional[int] = None):
        """out[b, i, j] = entry id of (rows[b, i], cols[b, j]).
        Ids >= row_limit/col_limit (the padding sentinels of the
        ragged block plans) are guaranteed misses, filled without
        probing."""
        import numpy as np
        r = np.ascontiguousarray(rows, dtype=np.int64)
        c = np.ascontiguousarray(cols, dtype=np.int64)
        B, nr = r.shape
        _, nc = c.shape
        big = np.iinfo(np.int64).max
        out = np.empty((B, nr, nc), dtype=np.int64)
        _PLANNER.csr_hash_block_i64(
            self._handle, _i64p(r.reshape(-1)), _i64p(c.reshape(-1)),
            B, nr, nc, stride,
            big if row_limit is None else row_limit,
            big if col_limit is None else col_limit,
            miss, _i64p(out.reshape(-1)))
        return out



def invert_to_padded(targets, srcs, n_targets: int, sentinel: int):
    """Native scatter->padded-gather inversion; None if unavailable."""
    import numpy as np
    L = planner()
    if L is None:
        return None
    t = np.ascontiguousarray(targets, dtype=np.int64)
    s = np.ascontiguousarray(srcs, dtype=np.int64)
    width = L.invert_to_padded_i64(_i64p(t), _i64p(s), t.size,
                                   n_targets, sentinel, 0, None)
    out = np.empty((n_targets, width), dtype=np.int64)
    L.invert_to_padded_i64(_i64p(t), _i64p(s), t.size, n_targets,
                           sentinel, width, _i64p(out))
    return out


def locate_sorted(sorted_arr, gids):
    """Native searchsorted-and-assume-present; None if unavailable."""
    import numpy as np
    L = planner()
    if L is None:
        return None
    sa = np.ascontiguousarray(sorted_arr, dtype=np.int64)
    g = np.ascontiguousarray(gids, dtype=np.int64)
    out = np.empty(g.shape, dtype=np.int64)
    L.locate_sorted_i64(_i64p(sa), sa.size, _i64p(g.reshape(-1)),
                        g.size, _i64p(out.reshape(-1)))
    return out
