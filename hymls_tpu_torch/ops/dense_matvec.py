"""The blocked dense matvec kernel: wrapper, launch count and plain
version.

`dense_matvec(M, x)` computes y = M x for a row-major contiguous
M f32[n, n] and x f32[n] (or f32[n, 1]), accumulating in f32, and
returns y in x's shape.  On a CUDA tensor it launches the hand-written
kernel of `csrc/dense_matvec.cu`, which replaces the Pallas TPU kernel
`tools/loop_pathology_bench.py:_mv_kernel` (`pl_matvec`); a launch that
fails raises.  The launch goes on `torch.cuda.current_stream()`, so a
CUDA-graph capture records it (and counts it once, at capture).  On a
CPU tensor it runs `dense_matvec_reference`, the plain torch version,
which is also what the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


def _check(M: torch.Tensor, x: torch.Tensor) -> int:
    if M.dim() != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"dense_matvec wants a square M, got "
                         f"{tuple(M.shape)}")
    n = M.shape[0]
    if tuple(x.shape) not in ((n,), (n, 1)):
        raise ValueError(f"dense_matvec wants x of shape ({n},) or "
                         f"({n}, 1), got {tuple(x.shape)}")
    if M.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"dense_matvec wants float32 tensors, got "
                        f"{M.dtype} and {x.dtype}")
    if M.device != x.device:
        raise ValueError(f"M on {M.device}, x on {x.device}")
    if not (M.is_contiguous() and x.is_contiguous()):
        raise ValueError("dense_matvec wants contiguous M and x")
    return n


def dense_matvec_reference(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain torch y = M x in f32, in x's shape."""
    _check(M, x)
    return (M @ x.reshape(-1, 1)).reshape(x.shape)


@functools.cache
def _lib():
    """The built kernel library with its C signature declared (every
    pointer and the stream as c_void_p: ctypes would otherwise pass
    them as 32-bit ints)."""
    lib = _build.load("dense_matvec")
    fn = lib.hymls_dense_matvec_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def dense_matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M x.  CUDA tensors go to the kernel (or raise); CPU tensors
    take `dense_matvec_reference`."""
    n = _check(M, x)
    if x.device.type == "cpu":
        return dense_matvec_reference(M, x)
    if x.device.type != "cuda":
        raise ValueError(f"dense_matvec: unsupported device {x.device}")
    fn = _lib().hymls_dense_matvec_f32
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(M.data_ptr(), x.data_ptr(), y.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"dense_matvec kernel launch failed: CUDA error "
                           f"{err} (n={n})")
    dense_matvec.launches += 1
    return y


#: kernel launches since the last reset (chip_smoke.py reads it)
dense_matvec.launches = 0
