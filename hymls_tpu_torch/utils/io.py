"""MatrixMarket I/O (reference MatrixUtils::mmread/mmwrite/Dump,
src/HYMLS_MatrixUtils.hpp:124-171) via scipy, plus linear-system
directory loading in the reference driver's layout
(HYMLS_MainUtils::read_matrix/read_vector)."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import scipy.io as sio
import scipy.sparse as sp


def read_matrix(path: str) -> sp.csr_matrix:
    # scipy >= 1.12 ships the C++ fast_matrix_market reader, which is
    # fastest; the ctypes C++ reader in ..native is the fallback for
    # environments without it.
    try:
        A = sio.mmread(path)
    except Exception:
        from ..native import read_matrix_market
        A = read_matrix_market(path)
    if sp.issparse(A):
        A = A.tocsr()
        A.sum_duplicates()
        A.sort_indices()
    return A


def write_matrix(path: str, A) -> None:
    sio.mmwrite(path, A)


def read_vector(path: str) -> np.ndarray:
    try:
        v = sio.mmread(path)
    except Exception:
        from ..native import read_matrix_market
        v = read_matrix_market(path)
    if sp.issparse(v):
        v = v.toarray()
    return np.asarray(v).ravel()


def write_vector(path: str, v) -> None:
    sio.mmwrite(path, np.asarray(v).reshape(-1, 1))


def write_multivector(path: str, v) -> None:
    """Write a dense (n, m) multivector in MatrixMarket array format."""
    v = np.asarray(v)
    if v.ndim == 1:
        v = v.reshape(-1, 1)
    sio.mmwrite(path, v)


def read_multivector(path: str) -> Optional[np.ndarray]:
    """Read a dense multivector: MatrixMarket, or the Epetra debug-dump
    format ('Epetra::MultiVector  MyPID  GID  Value...') that some
    reference datasets use."""
    try:
        return np.asarray(sio.mmread(path))
    except Exception:
        pass
    try:
        rows = []
        with open(path) as f:
            header = f.readline()
            if "Epetra::MultiVector" not in header:
                return None
            gid_vals = {}
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                gid = int(parts[1])
                gid_vals[gid] = [float(v) for v in parts[2:]]
        n = max(gid_vals) + 1
        m = len(next(iter(gid_vals.values())))
        out = np.zeros((n, m))
        for g, vals in gid_vals.items():
            out[g] = vals
        return out
    except Exception:
        return None


def read_linear_system(datadir: str):
    """Read (K, b, x_ex, nullspace, mass) from a reference-layout data
    directory: matrix.mtx, rhs.mtx, sol.mtx, nullSpace.mtx, mass.mtx
    (reference HYMLS_MainUtils.cpp read_matrix/read_vector naming)."""
    def maybe(name, reader):
        for fn in (name, name + ".mtx", name + ".mm",
                   name + ".mtx.gz", name + ".mm.gz"):
            p = os.path.join(datadir, fn)
            if os.path.exists(p):
                return reader(p)
        return None

    K = maybe("matrix", read_matrix)
    if K is None:
        K = maybe("jac", read_matrix)
    if K is None:
        raise FileNotFoundError(f"no matrix found in {datadir}")
    b = maybe("rhs", read_vector)
    x_ex = maybe("sol", read_vector)
    nullspace = maybe("nullSpace", read_multivector)
    mass = maybe("mass", read_matrix)
    return K, b, x_ex, nullspace, mass


# ---------------------------------------------------------------------------
# HDF5 dumps (reference MatrixUtils::Dump via EpetraExt_HDF5,
# src/HYMLS_MatrixUtils.hpp:124-158)
# ---------------------------------------------------------------------------

def write_hdf5(path: str, **objects) -> None:
    """Write named matrices (scipy sparse -> CSR triplet datasets) and
    vectors/arrays into one HDF5 file."""
    import h5py
    with h5py.File(path, "w") as f:
        for name, obj in objects.items():
            if sp.issparse(obj):
                A = obj.tocsr()
                g = f.create_group(name)
                g.attrs["format"] = "csr"
                g.attrs["shape"] = A.shape
                g.create_dataset("indptr", data=A.indptr)
                g.create_dataset("indices", data=A.indices)
                g.create_dataset("data", data=A.data)
            else:
                f.create_dataset(name, data=np.asarray(obj))


def read_hdf5(path: str):
    """Read back a dict of matrices/arrays written by write_hdf5."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        for name, obj in f.items():
            if isinstance(obj, h5py.Group) and \
                    obj.attrs.get("format") == "csr":
                out[name] = sp.csr_matrix(
                    (obj["data"][...], obj["indices"][...],
                     obj["indptr"][...]),
                    shape=tuple(obj.attrs["shape"]))
            else:
                out[name] = obj[...]
    return out
