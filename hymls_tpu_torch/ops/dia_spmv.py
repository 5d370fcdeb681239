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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import _build

#: band cap of make_operator, and the size of the kernel's offset struct
MAX_BANDS = 48

_DTYPES = (torch.float32, torch.float64)


def _check(bands: torch.Tensor, x: torch.Tensor,
           offsets: Sequence[int]) -> Tuple[int, ...]:
    offsets = tuple(int(o) for o in offsets)
    k = len(offsets)
    if not 1 <= k <= MAX_BANDS:
        raise ValueError(f"dia_matvec takes 1..{MAX_BANDS} bands, got {k}")
    if x.dim() != 1 or bands.dim() != 2:
        raise ValueError("dia_matvec wants bands (k, n) and x (n,)")
    if tuple(bands.shape) != (k, x.shape[0]):
        raise ValueError(f"bands shape {tuple(bands.shape)} != "
                         f"({k}, {x.shape[0]})")
    if bands.dtype != x.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"dia_matvec wants matching float32/float64 "
                        f"tensors, got {bands.dtype} and {x.dtype}")
    if bands.device != x.device:
        raise ValueError(f"bands on {bands.device}, x on {x.device}")
    if not (bands.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_matvec wants contiguous bands and x")
    return offsets


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


@functools.cache
def _lib():
    """The built kernel library with its C signatures declared (every
    pointer and the stream as c_void_p: ctypes would otherwise pass
    them as 32-bit ints)."""
    lib = _build.load("dia_spmv")
    for fn in (lib.hymls_dia_spmv_f32, lib.hymls_dia_spmv_f64):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def dia_matvec(bands: torch.Tensor, x: torch.Tensor,
               offsets: Sequence[int]) -> torch.Tensor:
    """y = DIA(bands, offsets) @ x.  CUDA tensors go to the kernel (or
    raise); CPU tensors take `dia_matvec_reference`."""
    offsets = _check(bands, x, offsets)
    if x.device.type == "cpu":
        return dia_matvec_reference(bands, x, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"dia_matvec: unsupported device {x.device}")
    lib = _lib()
    fn = lib.hymls_dia_spmv_f32 if x.dtype == torch.float32 \
        else lib.hymls_dia_spmv_f64
    n = x.shape[0]
    y = torch.empty_like(x)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(bands.data_ptr(), bands.stride(0), x.data_ptr(),
                 y.data_ptr(), n, ctypes.addressof(offs), len(offsets),
                 stream)
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error "
                           f"{err} (n={n}, k={len(offsets)}, "
                           f"dtype={x.dtype})")
    dia_matvec.launches += 1
    return y


#: kernel launches since the last reset (chip_smoke.py reads it)
dia_matvec.launches = 0
