"""The DIA SpMV kernel: wrapper, launch count and plain version.

`dia_matvec(bands, x, offsets)` computes

    y[i] = sum_k bands[k, i] * x[i + offsets[k]],   x == 0 outside [0, n)

On a CUDA tensor it launches the hand-written kernel of
`csrc/dia_spmv.cu` (f32 and f64), which replaces the Pallas TPU kernel
`hymls_tpu/ops/pallas_spmv.py:_kernel`; a launch that fails raises.  On
a CPU tensor it runs `dia_matvec_reference`, the plain torch version
(a zero pad plus shifted slices, as `hymls_tpu/ops/spmv.py`'s
`DiaOperator.matvec_prepared`), which is also what the kernel is held
against on the card.

An operator whose offsets are fixed packs them once (`DiaOffsets`) and
calls `dia_matvec_packed`, which checks per call only what can change:
device, dtype, shape and layout of the tensors.

`dia_matmat(bands, X, offsets)` is the multi-column form for a block X
of shape (B, n), one vector per row:

    Y[c, i] = sum_k bands[k, i] * X[c, i + offsets[k]]

On a CUDA tensor it is one launch of the kernel's multi-column entry
point (the bands read once for the block; a grid of row tiles x groups
of up to 8 vectors, `matmat_plan` says which instance a shape takes),
which replaces `PallasDiaMatvec` under `jax.vmap` in the JAX package's
batched deflation setup; each row of Y equals `dia_matvec` of that row
of X bit for bit.  On a CPU tensor it runs `dia_matmat_reference`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build

#: band cap of make_operator, and the size of the kernel's offset struct
MAX_BANDS = 48

_DTYPES = (torch.float32, torch.float64)
#: the kernel indexes in 32 bits: n < 2^30 rows and k * n < 2^31 elements
_MAX_ROWS = 1 << 30
_MAX_ELEMENTS = 1 << 31


class DiaOffsets:
    """The band offsets of one DIA matrix, checked and packed once: the
    tuple for the plain version and a C int array for the kernel."""

    __slots__ = ("offsets", "k", "_c", "ptr")

    def __init__(self, offsets: Sequence[int]):
        self.offsets = tuple(int(o) for o in offsets)
        self.k = len(self.offsets)
        if not 1 <= self.k <= MAX_BANDS:
            raise ValueError(f"dia_matvec takes 1..{MAX_BANDS} bands, "
                             f"got {self.k}")
        self._c = (ctypes.c_int * self.k)(*self.offsets)
        self.ptr = ctypes.addressof(self._c)

    def __reduce__(self):
        # a copy packs its own array: `ptr` must not outlive `_c`
        return DiaOffsets, (self.offsets,)


def _check(bands: torch.Tensor, x: torch.Tensor, k: int) -> None:
    if x.dim() != 1 or bands.dim() != 2:
        raise ValueError("dia_matvec wants bands (k, n) and x (n,)")
    if bands.shape[0] != k or bands.shape[1] != x.shape[0]:
        raise ValueError(f"bands shape {tuple(bands.shape)} != "
                         f"({k}, {x.shape[0]})")
    if bands.dtype != x.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"dia_matvec wants matching float32/float64 "
                        f"tensors, got {bands.dtype} and {x.dtype}")
    if bands.device != x.device:
        raise ValueError(f"bands on {bands.device}, x on {x.device}")
    if not (bands.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_matvec wants contiguous bands and x")


def dia_matvec_reference(bands: torch.Tensor, x: torch.Tensor,
                         offsets: Sequence[int]) -> torch.Tensor:
    """Plain torch DIA matvec: the sum over bands of elementwise
    products with statically shifted slices of the zero-padded x, in
    band order (ops/spmv.py:174-180 of the JAX package)."""
    offsets = tuple(int(o) for o in offsets)
    n = x.shape[0]
    pad = max(max((abs(o) for o in offsets), default=1), 1)
    x_pad = torch.nn.functional.pad(x, (pad, pad))
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        y = y + bands[k, :n] * x_pad[pad + off:pad + off + n]
    return y


def _check_block(bands: torch.Tensor, X: torch.Tensor, k: int) -> None:
    if X.dim() != 2 or bands.dim() != 2:
        raise ValueError("dia_matmat wants bands (k, n) and X (B, n)")
    if bands.shape[0] != k or bands.shape[1] != X.shape[1]:
        raise ValueError(f"bands shape {tuple(bands.shape)} != "
                         f"({k}, {X.shape[1]})")
    if bands.dtype != X.dtype or X.dtype not in _DTYPES:
        raise TypeError(f"dia_matmat wants matching float32/float64 "
                        f"tensors, got {bands.dtype} and {X.dtype}")
    if bands.device != X.device:
        raise ValueError(f"bands on {bands.device}, X on {X.device}")
    if not (bands.is_contiguous() and X.is_contiguous()):
        raise ValueError("dia_matmat wants contiguous bands and X")


def dia_matmat_reference(bands: torch.Tensor, X: torch.Tensor,
                         offsets: Sequence[int]) -> torch.Tensor:
    """Plain torch multi-column DIA product: `dia_matvec_reference`'s
    padded shifted slices, broadcast over the leading axis of X (B, n),
    so that each row equals `dia_matvec_reference` of that row bit for
    bit."""
    offsets = tuple(int(o) for o in offsets)
    n = X.shape[-1]
    pad = max(max((abs(o) for o in offsets), default=1), 1)
    x_pad = torch.nn.functional.pad(X, (pad, pad))
    y = torch.zeros_like(X)
    for k, off in enumerate(offsets):
        y = y + bands[k, :n] * x_pad[..., pad + off:pad + off + n]
    return y


@functools.cache
def _entry(dtype: torch.dtype):
    """The kernel's C entry point for `dtype`, from the library built at
    first use, with its signature declared (every pointer and the stream
    as c_void_p: ctypes would otherwise pass them as 32-bit ints)."""
    lib = _build.load("dia_spmv")
    fn = lib.hymls_dia_spmv_f32 if dtype == torch.float32 \
        else lib.hymls_dia_spmv_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry_mm(dtype: torch.dtype):
    """The multi-column entry point for `dtype`, as `_entry`."""
    lib = _build.load("dia_spmv")
    fn = lib.hymls_dia_spmm_f32 if dtype == torch.float32 \
        else lib.hymls_dia_spmm_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _plan_entry():
    lib = _build.load("dia_spmv")
    fn = lib.hymls_dia_spmm_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmat_plan(n: int, nvec: int, k: int, dtype: torch.dtype) -> dict:
    """What the multi-column kernel's launcher runs for B = `nvec`
    vectors of n rows with k bands in `dtype`: the instance (`bucket`,
    the band count compiled; `vb`, vectors a thread; `rounds` of band
    loads) and the launch (`threads` a block, `blocks`).  Needs the
    built library (a CUDA machine); raises where a launch would."""
    out = (ctypes.c_int * 5)()
    err = _plan_entry()(n, nvec, k, torch.finfo(dtype).bits // 8,
                        ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"dia_matmat: no plan for B={nvec}, n={n}, k={k}, "
                         f"{dtype} (CUDA error {err})")
    return dict(zip(("bucket", "vb", "rounds", "threads", "blocks"), out))


def _launch(fn, dev: torch.device, args) -> int:
    """fn(*args, stream) on `dev`'s current stream.  The raw handle of
    the stream: 0.1 us against ~3 us for
    torch.cuda.current_stream(dev).cuda_stream, which builds a Stream."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def dia_matvec_packed(bands: torch.Tensor, x: torch.Tensor,
                      offs: DiaOffsets) -> torch.Tensor:
    """y = DIA(bands, offs) @ x.  CUDA tensors go to the kernel (or
    raise); CPU tensors take `dia_matvec_reference`."""
    _check(bands, x, offs.k)
    dev = x.device
    if dev.type == "cpu":
        return dia_matvec_reference(bands, x, offs.offsets)
    if dev.type != "cuda":
        raise ValueError(f"dia_matvec: unsupported device {dev}")
    n = x.shape[0]
    if n >= _MAX_ROWS or offs.k * n >= _MAX_ELEMENTS:
        raise ValueError(f"dia_matvec kernel: n = {n} with {offs.k} bands "
                         f"is beyond its 32-bit indices")
    fn = _entry(x.dtype)
    y = torch.empty_like(x)
    if n == 0:
        return y
    err = _launch(fn, dev, (bands.data_ptr(), n, x.data_ptr(),
                            y.data_ptr(), n, offs.ptr, offs.k))
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error "
                           f"{err} (n={n}, k={offs.k}, dtype={x.dtype})")
    dia_matvec.launches += 1
    return y


def dia_matvec(bands: torch.Tensor, x: torch.Tensor,
               offsets: Sequence[int]) -> torch.Tensor:
    """`dia_matvec_packed` for offsets given as a sequence, packed on
    this call."""
    return dia_matvec_packed(bands, x, DiaOffsets(offsets))


def dia_matmat_packed(bands: torch.Tensor, X: torch.Tensor,
                      offs: DiaOffsets) -> torch.Tensor:
    """Y = DIA(bands, offs) @ each row of X (B, n), in one launch of the
    multi-column kernel on CUDA tensors (or raise); CPU tensors take
    `dia_matmat_reference`."""
    _check_block(bands, X, offs.k)
    dev = X.device
    if dev.type == "cpu":
        return dia_matmat_reference(bands, X, offs.offsets)
    # the kernel's limits, checked before the device so that a tensor
    # without storage (device "meta") shows them
    nvec, n = X.shape
    if n >= _MAX_ROWS or offs.k * n >= _MAX_ELEMENTS or \
            nvec * n >= _MAX_ELEMENTS:
        raise ValueError(f"dia_matmat kernel: {nvec} vectors of n = {n} "
                         f"with {offs.k} bands is beyond its 32-bit "
                         f"indices")
    if dev.type != "cuda":
        raise ValueError(f"dia_matmat: unsupported device {dev}")
    fn = _entry_mm(X.dtype)
    Y = torch.empty_like(X)
    if n == 0 or nvec == 0:
        return Y
    err = _launch(fn, dev, (bands.data_ptr(), n, X.data_ptr(),
                            Y.data_ptr(), n, nvec, offs.ptr, offs.k))
    if err != 0:
        raise RuntimeError(f"dia_spmm kernel launch failed: CUDA error "
                           f"{err} (B={nvec}, n={n}, k={offs.k}, "
                           f"dtype={X.dtype})")
    dia_matmat.launches += 1
    return Y


def dia_matmat(bands: torch.Tensor, X: torch.Tensor,
               offsets: Sequence[int]) -> torch.Tensor:
    """`dia_matmat_packed` for offsets given as a sequence, packed on
    this call."""
    return dia_matmat_packed(bands, X, DiaOffsets(offsets))


#: kernel launches since the last reset (chip_smoke.py reads them)
dia_matvec.launches = 0
dia_matmat.launches = 0
