"""The sentinel gather kernel K3: wrapper, launch count and plain
version.

`sentinel_gather(src, idx)` is `torch.cat([src, zeros(1)])[idx]`, the
static gather of the generic V-cycle and of the factorization: `idx`
(int64, any shape) holds offsets into `src` (..., L), and the offset L
is the sentinel, which reads 0.  The result has the shape
`src.shape[:-1] + idx.shape` and `src`'s dtype.

On a CUDA tensor it launches the hand-written kernel of
`csrc/gather.cu` (f32 and f64), which reads `src` in place and writes
each output once: one launch where the plain version takes three.
Every call goes through `_BlockGather`, an `autograd.Function` whose
vmap rule moves the batch axis to the front and launches once for the
whole block, so the vmap of the apply (a (B, n) block) gathers every
vector of the block in one launch (a `torch.library` custom op would
import the compiler stack at its first call, seconds of set-up).
Launches go on `torch.cuda.current_stream()`, so a CUDA-graph capture
records them (and counts them once, at capture); a launch that fails
raises, and another dtype raises.  The kernel reads 0 for any offset
outside [0, L], where the plain version raises or wraps: it relies on
the plans, whose apply offsets `core/preconditioner.py:
finish_level_plan` checks once when a plan is built.  On a CPU tensor
it runs `sentinel_gather_reference`, the plain version, which is also
what the kernel is held against on the card.

Counters (`utils/timings.py`): `hymls.gather.kernel` per kernel call,
`hymls.gather.plain` per plain-version call.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from ..utils.timings import count

_ENTRY = {torch.float32: "hymls_sentinel_gather_f32",
          torch.float64: "hymls_sentinel_gather_f64"}


def sentinel_gather_reference(src: torch.Tensor,
                              idx: torch.Tensor) -> torch.Tensor:
    """Plain torch: append the 0.0 sentinel slot to the last axis of
    `src`, then index it with `idx`."""
    if src.dim() == 1:
        return torch.cat([src, src.new_zeros(1)])[idx]
    ext = torch.cat([src, src.new_zeros(src.shape[:-1] + (1,))], dim=-1)
    return ext[..., idx]


@functools.cache
def _lib():
    """The built kernel library with its C signatures declared (every
    pointer and the stream as c_void_p: ctypes would otherwise pass
    them as 32-bit ints)."""
    lib = _build.load("gather")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One kernel launch: `src` (..., L) with its leading axes read as
    one batch axis, through its strides where they allow that."""
    if src.dtype not in _ENTRY:
        raise TypeError(f"sentinel_gather: the kernel takes float32 and "
                        f"float64, got {src.dtype}")
    if idx.dtype != torch.int64:
        raise TypeError(f"sentinel_gather: int64 offsets, got {idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"src on {src.device}, idx on {idx.device}")
    L = src.shape[-1]
    s2 = src.reshape(math.prod(src.shape[:-1]), L)
    sb, sl = s2.stride()
    idx = idx.contiguous()
    out = torch.empty(s2.shape[0], idx.numel(), dtype=src.dtype,
                      device=src.device)
    fn = getattr(_lib(), _ENTRY[src.dtype])
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(s2.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                 L, s2.shape[0], sb, sl, stream)
    if err != 0:
        raise RuntimeError(f"sentinel_gather kernel launch failed: CUDA "
                           f"error {err} (src {tuple(src.shape)}, idx "
                           f"{tuple(idx.shape)})")
    count("hymls.gather.kernel")
    sentinel_gather.launches += 1
    return out.view(src.shape[:-1] + idx.shape)


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if src.device.type == "cuda":
        return _launch(src, idx)
    if src.device.type != "cpu":
        raise ValueError(f"sentinel_gather: unsupported device {src.device}")
    count("hymls.gather.plain")
    return sentinel_gather_reference(src, idx)


class _BlockGather(torch.autograd.Function):
    """The gather of a source that `torch.func.vmap` batches: its vmap
    rule moves the batch axis of `src` to the front and gathers the
    whole block in one call.  The offsets are a plan's, never batched."""

    @staticmethod
    def forward(src, idx):
        return _gather(src, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, src, idx):
        src_dim, idx_dim = in_dims
        if idx_dim is not None:
            raise ValueError("sentinel_gather: batched offsets are not "
                             "supported")
        return _BlockGather.apply(src.movedim(src_dim, 0), idx), 0


def sentinel_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`torch.cat([src, zeros(1)])[idx]`.  CUDA tensors go to the kernel
    (or raise), under vmap one launch for the whole block; CPU tensors
    take `sentinel_gather_reference`."""
    return _BlockGather.apply(src, idx)


#: kernel launches since the last reset (chip_smoke.py reads it)
sentinel_gather.launches = 0
