"""The port's DIA SpMV (K1) against the JAX package's, at small versions
of the geometries the kernel is measured on and at edge cases.

Each case builds one scipy matrix with numpy and holds the port's
`DiaOperator.matvec_prepared` (on the CPU: the wrapper's plain version,
on the offsets packed once per operator) against
`hymls_tpu.ops.spmv.DiaOperator.matvec_prepared`, and in f32 against the
JAX package's Pallas kernel run in interpret mode.  Tolerances: 1e-5
relative in f32 (another summation order than XLA's), 1e-13 in f64.
The CUDA kernel itself is held against the plain version by the
`cuda`-marked test in tests/test_torch_spmv.py and by chip_smoke.py.
"""
import copy

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp
import torch

from hymls_tpu.ops import spmv as jspmv
from hymls_tpu.ops.pallas_spmv import HAVE_PALLAS, PallasDiaMatvec
from hymls_tpu_torch.ops import spmv as tspmv
from hymls_tpu_torch.ops.dia_spmv import (DiaOffsets, MAX_BANDS, dia_matvec,
                                          dia_matvec_packed,
                                          dia_matvec_reference)
from hymls_tpu_torch.stencils import stokes2d, stokes3d
from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "f64": (torch.float64, jnp.float64, 1e-13)}


def _banded(n, offsets, seed):
    """A random CSR matrix with exactly the given band offsets (every
    in-range entry of each band nonzero)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rng.standard_normal(rows.size) + 0.5
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


# small versions of the measured geometries, then edge cases
CASES = {
    "cavity16": lambda: cavity_jacobian(16, 16, re=1000.0),
    "stokes2d_16": lambda: stokes2d(16, 16),
    "stokes3d_8": lambda: stokes3d(8, 8, 8),
    "k1": lambda: _banded(300, [3], 1),
    "k48": lambda: _banded(1000, list(range(-30, 18)), 2),
    "all_positive": lambda: _banded(577, [1, 2, 40, 300, 576], 3),
    "all_negative": lambda: _banded(577, [-576, -301, -7, -1], 4),
    "ragged_past_half": lambda: _banded(9, [-8, -5, 0, 4, 7], 5),
    "ragged_1001": lambda: _banded(1001, [-500, -33, -1, 0, 1, 33, 501], 6),
    "n1": lambda: _banded(1, [0], 7),
}


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(ref - np.asarray(got, np.float64)).max()
                 / max(np.abs(ref).max(), 1e-300))


def _both(name, dt):
    tdt, jdt, tol = DTYPES[dt]
    K = CASES[name]().tocsr()
    jop = jspmv.DiaOperator(K, dtype=jdt)
    top = tspmv.DiaOperator(K, dtype=tdt, device="cpu")
    x = np.random.default_rng(11).standard_normal(K.shape[0])
    return K, jop, top, x, tdt, jdt, tol


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_packed_operator_matches_reference(name, dt):
    K, jop, top, x, tdt, jdt, tol = _both(name, dt)
    assert top.offsets == tuple(int(o) for o in jop.offsets)
    assert top.packed.offsets == top.offsets
    assert len(top.offsets) <= MAX_BANDS
    bands_j = jop.prepare(jop.vals)
    bands_t = top.prepare(top.vals)
    y_ref = jop.matvec_prepared(bands_j, jnp.asarray(x, jdt))
    y = top.matvec_prepared(bands_t, torch.as_tensor(x, dtype=tdt))
    assert y.dtype == tdt and tuple(y.shape) == (K.shape[0],)
    assert _rel(y_ref, y) <= tol
    assert _rel(K @ x, y) <= tol


@pytest.mark.skipif(not HAVE_PALLAS, reason="no pallas")
@pytest.mark.parametrize("name", list(CASES))
def test_matches_pallas_interpret(name):
    """f32 (the Pallas kernel's only type): the port against K1's Pallas
    kernel in interpret mode on the same bands and x."""
    K, _, top, x, _, _, tol = _both(name, "f32")
    bands = top.prepare(top.vals)
    pk = PallasDiaMatvec(top.offsets, top.n, block=256, interpret=True)
    y_ref = np.asarray(pk(jnp.asarray(bands.numpy()),
                          jnp.asarray(x, jnp.float32)))
    y = top.matvec_prepared(bands, torch.as_tensor(x, dtype=torch.float32))
    assert _rel(y_ref, y) <= tol


@pytest.mark.parametrize("name", ["cavity16", "stokes3d_8", "all_negative",
                                  "n1"])
def test_packed_equals_public_call(name):
    """The operator's once-packed offsets give exactly the result of
    `dia_matvec(bands, x, offsets)`, and no launch is counted on CPU."""
    _, _, top, x, tdt, _, _ = _both(name, "f64")
    bands = top.prepare(top.vals)
    xt = torch.as_tensor(x, dtype=tdt)
    before = dia_matvec.launches
    y_packed = top.matvec_prepared(bands, xt)
    y_public = dia_matvec(bands, xt, top.offsets)
    assert dia_matvec.launches == before
    assert torch.equal(y_packed, y_public)
    assert torch.equal(y_packed, dia_matvec_reference(bands, xt,
                                                      top.offsets))


def test_packed_offsets_copy_and_checks():
    offs = DiaOffsets(np.array([-4, 0, 7]))
    assert offs.offsets == (-4, 0, 7) and offs.k == 3
    dup = copy.deepcopy(offs)
    assert dup.offsets == offs.offsets and dup.ptr != offs.ptr
    for bad in ([], list(range(MAX_BANDS + 1))):
        with pytest.raises(ValueError):
            DiaOffsets(bad)
    bands, x = torch.zeros((3, 8)), torch.zeros(8)
    with pytest.raises(ValueError):
        dia_matvec_packed(torch.zeros((2, 8)), x, offs)
    with pytest.raises(TypeError):
        dia_matvec_packed(bands, x.double(), offs)
    assert torch.equal(dia_matvec_packed(bands, x, offs), torch.zeros(8))
