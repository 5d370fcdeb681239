"""The port's sparse operators and DIA kernel wrapper against the JAX
package's.

On the CPU `dia_matvec` runs its plain torch version and counts no
launch; the CUDA kernel itself is held against that plain version by
the `cuda`-marked test below (skipped without a card) and by
chip_smoke.py on the card.  Tolerances: 1e-5 relative in f32 (other
summation order than XLA), 1e-13 in f64.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hymls_tpu.ops import spmv as jspmv
from hymls_tpu.ops.pallas_spmv import HAVE_PALLAS, PallasDiaMatvec
from hymls_tpu_torch.ops import spmv as tspmv
from hymls_tpu_torch.ops.dia_spmv import (dia_matvec, dia_matvec_reference,
                                          MAX_BANDS)
from hymls_tpu_torch.stencils import laplace2d, stokes2d, stokes3d, laplace3d
from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian

MATRICES = {
    "laplace2d_24": lambda: laplace2d(24, 24),
    "stokes2d_16": lambda: stokes2d(16, 16),
    "laplace3d_8": lambda: laplace3d(8, 8, 8),
    "cavity16_re1000": lambda: cavity_jacobian(16, 16, re=1000.0),
}
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "f64": (torch.float64, jnp.float64, 1e-13)}


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(ref - np.asarray(got, np.float64)).max()
                 / max(np.abs(ref).max(), 1e-300))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(MATRICES))
def test_dia_matches_reference(name, dt):
    tdt, jdt, tol = DTYPES[dt]
    K = MATRICES[name]().tocsr()
    jop = jspmv.DiaOperator(K, dtype=jdt)
    top = tspmv.DiaOperator(K, dtype=tdt, device="cpu")
    assert isinstance(top, torch.nn.Module)
    assert top.offsets == tuple(int(o) for o in jop.offsets)
    assert np.array_equal(top.vidx.numpy(), jop.vidx)
    x = np.random.default_rng(0).standard_normal(K.shape[0])
    bands_t = top.prepare(top.vals)
    assert bands_t.is_contiguous() and bands_t.dtype == tdt
    assert _rel(jop.prepare(jop.vals), bands_t) == 0.0
    y_ref = jop(jnp.asarray(x, jdt))
    y = top(torch.as_tensor(x, dtype=tdt))
    assert y.dtype == tdt
    assert _rel(y_ref, y) <= tol


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(MATRICES))
def test_ell_matches_reference(name, dt):
    tdt, jdt, tol = DTYPES[dt]
    K = MATRICES[name]().tocsr()
    jop = jspmv.EllOperator(K, dtype=jdt)
    top = tspmv.EllOperator(K, dtype=tdt, device="cpu")
    x = np.random.default_rng(1).standard_normal(K.shape[0])
    assert _rel(jop(jnp.asarray(x, jdt)), top(torch.as_tensor(x, dtype=tdt))) \
        <= tol


def test_make_operator_band_cap():
    K = laplace2d(12, 12)
    assert isinstance(tspmv.make_operator(K, device="cpu"),
                      tspmv.DiaOperator)
    assert isinstance(tspmv.make_operator(K, max_bands=3, device="cpu"),
                      tspmv.EllOperator)


@pytest.mark.skipif(not HAVE_PALLAS, reason="no pallas")
def test_ragged_case_matches_pallas_interpret():
    """n = 577 with offsets reaching past both ends: the port's plain
    version against the Pallas kernel run in interpret mode."""
    n = 577
    offsets = [-25, -1, 0, 1, 25]
    rng = np.random.default_rng(1)
    bands = rng.standard_normal((len(offsets), n)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    pk = PallasDiaMatvec(offsets, n, block=256, interpret=True)
    y_ref = np.asarray(pk(jnp.asarray(bands), jnp.asarray(x)))
    y = dia_matvec(torch.as_tensor(bands), torch.as_tensor(x), offsets)
    assert _rel(y_ref, y) <= 1e-5


def test_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(2)
    offsets = (-3, 0, 2)
    bands = torch.as_tensor(rng.standard_normal((3, 40)))
    x = torch.as_tensor(rng.standard_normal(40))
    before = dia_matvec.launches
    y = dia_matvec(bands, x, offsets)
    assert dia_matvec.launches == before
    assert torch.equal(y, dia_matvec_reference(bands, x, offsets))
    # dense check of the definition, zero outside [0, n)
    A = np.zeros((40, 40))
    for k, off in enumerate(offsets):
        for i in range(40):
            if 0 <= i + off < 40:
                A[i, i + off] = bands[k, i]
    assert _rel(A @ x.numpy(), y) <= 1e-14


@pytest.mark.parametrize("bad", ["bands", "dtype", "shape", "layout"])
def test_wrapper_rejects_bad_input(bad):
    n = 16
    bands = torch.zeros((3, n))
    x = torch.zeros(n)
    offsets = (-1, 0, 1)
    if bad == "bands":
        bands, offsets = torch.zeros((MAX_BANDS + 1, n)), \
            tuple(range(MAX_BANDS + 1))
    elif bad == "dtype":
        x = x.double()
    elif bad == "shape":
        bands = torch.zeros((3, n + 1))
    else:
        bands = torch.zeros((n, 3)).T
    with pytest.raises((ValueError, TypeError)):
        dia_matvec(bands, x, offsets)


#: the kernel's cases on the card: the geometries (cavity 256^2 is the
#: one whose f64 grid exceeds one wave, so its loads go in two rounds),
#: then ragged n, offsets past half of n, and n = 1
CUDA_CASES = {
    "cavity32": lambda: cavity_jacobian(32, 32, re=1000.0),
    **{k: MATRICES[k] for k in ("cavity16_re1000", "stokes2d_16")},
    "stokes3d_8": lambda: stokes3d(8, 8, 8),
    "cavity256": lambda: cavity_jacobian(256, 256, re=1000.0),
    "ragged577": (577, (-25, -1, 0, 1, 25)),
    "ragged_past_half": (9, (-8, -5, 0, 4, 7)),
    "k48": (1000, tuple(range(-30, 18))),
    "n1": (1, (0,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("x_start", [0, 1])
@pytest.mark.parametrize("case", list(CUDA_CASES))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_cuda_kernel_matches_plain_version(cuda_device, dt, case, x_start):
    """The hand-written kernel on the card against the plain version
    on the same inputs (FMA contraction: 1e-6 in f32, 1e-14 in f64),
    with x at the start of its buffer and one element into it (not
    16-byte aligned: the kernel asks no alignment)."""
    tdt = DTYPES[dt][0]
    tol = 1e-6 if tdt == torch.float32 else 1e-14
    rng = np.random.default_rng(3)
    spec = CUDA_CASES[case]
    if callable(spec):
        op = tspmv.DiaOperator(spec().tocsr(), dtype=tdt, device=cuda_device)
        bands, offsets = op.prepare(op.vals), op.offsets
    else:
        n, offsets = spec
        bands = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                                dtype=tdt, device=cuda_device)
    n = bands.shape[1]
    buf = torch.as_tensor(rng.standard_normal(n + 1), dtype=tdt,
                          device=cuda_device)
    x = buf[x_start:x_start + n]
    before = dia_matvec.launches
    y = dia_matvec(bands, x, offsets)
    torch.cuda.synchronize()
    assert dia_matvec.launches == before + 1
    y_ref = dia_matvec_reference(bands, x, offsets)
    assert tuple(y.shape) == (n,) and bool(torch.isfinite(y).all())
    assert _rel(y_ref.cpu(), y.cpu()) <= tol
