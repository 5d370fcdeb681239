"""The three cross-rank primitives of the reference, as explicit calls.

The JAX package moves data between shards with `lax.ppermute` (static
send lists), `lax.psum` and a tiled `lax.all_gather` inside shard_map
bodies.  Here each is a call on the mesh's process group, with the same
semantics:

  * `ppermute(mesh, x, pairs)`: every (src, dst) pair sends src's x to
    dst; all sends and receives are posted (`batch_isend_irecv`) before
    any is waited on, and a rank that receives from nobody gets zeros;
  * `psum(mesh, x)`: the sum over the ranks (`all_reduce`);
  * `all_gather(mesh, x, tiled=True)`: the ranks' x concatenated along
    the first axis; shards may differ in length (`sizes`), down to 0.

Transport: on "nccl" the device tensors travel as they are; on "gloo" a
CUDA tensor is copied to the host, exchanged, and copied back (gloo's
send and receive take host tensors only).  Complex tensors travel as
their real view.  Each call adds to the mesh's counters (calls, and the
bytes this rank sent), which is what the tests read in place of the
reference's compiled-program greps.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _wire(mesh, x):
    """The buffer that crosses: contiguous, real, on the host under
    gloo staging."""
    x = x.contiguous()
    if x.is_complex():
        x = torch.view_as_real(x)
    if mesh.staged:
        x = x.cpu()
    return x


def _unwire(mesh, buf, like):
    """`_wire` undone: back on the mesh's device in `like`'s dtype."""
    if like.is_complex():
        buf = torch.view_as_complex(buf)
    if mesh.staged:
        buf = buf.to(like.device)
    return buf


def _count(mesh, prim, nbytes):
    c = mesh.counters[prim]
    c["calls"] += 1
    c["bytes"] += int(nbytes)


def ppermute(mesh, x: torch.Tensor, pairs: Iterable[Tuple[int, int]],
             tag: Optional[str] = None) -> torch.Tensor:
    """`lax.ppermute`: x of rank src arrives at rank dst for every pair
    (a permutation: each rank sends to and receives from at most one
    rank).  Returns what this rank received, zeros if nothing.  A pair
    (r, r) is a local copy.  `tag` files the words sent under
    mesh.counters["ppermute_words"][tag]."""
    r = mesh.rank
    dst = [d for s, d in pairs if s == r]
    src = [s for s, d in pairs if d == r]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute pairs are not a permutation: {pairs}")
    buf = _wire(mesh, x)
    out = torch.zeros_like(buf)
    sent = 0
    ops = []
    if dst and dst[0] == r:
        out.copy_(buf)
    elif dst:
        ops.append(dist.P2POp(dist.isend, buf, dst[0], mesh.group))
        sent = buf.numel() * buf.element_size()
    if src and src[0] != r:
        ops.append(dist.P2POp(dist.irecv, out, src[0], mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _count(mesh, "ppermute", sent)
    if tag is not None:
        words = mesh.counters["ppermute_words"]
        words[tag] = words.get(tag, 0) + (x.numel() if sent else 0)
    return _unwire(mesh, out, x)


def shift(mesh, x: torch.Tensor, d: int, tag: Optional[str] = None):
    """ppermute by rank offset d without wrap-around: rank i sends to
    i + d; the ranks at the ends receive zeros."""
    n = mesh.size
    return ppermute(mesh, x, [(i, i + d) for i in range(n)
                              if 0 <= i + d < n], tag=tag)


def psum(mesh, x: torch.Tensor) -> torch.Tensor:
    """`lax.psum`: the sum of x over the ranks, on every rank."""
    buf = _wire(mesh, x)
    if buf.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        buf = buf.clone()            # all_reduce works in place
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    _count(mesh, "psum", buf.numel() * buf.element_size())
    return _unwire(mesh, buf, x)


def all_gather(mesh, x: torch.Tensor, tiled: bool = True,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`lax.all_gather`: the ranks' x stacked (tiled=False) or
    concatenated along the first axis (tiled=True).  `sizes`, the first
    dimension of every rank's x, allows shards of different lengths
    (tiled only), zero included: each is padded to the longest for the
    exchange and cut back after it."""
    n = mesh.size
    if sizes is None:
        sizes = [x.shape[0]] * n if x.dim() else None
    elif not tiled:
        raise ValueError("shards of different sizes need tiled=True")
    elif len(sizes) != n or sizes[mesh.rank] != x.shape[0]:
        raise ValueError(f"sizes {list(sizes)} do not match rank "
                         f"{mesh.rank}'s shard of {x.shape[0]}")
    width = max(sizes) if sizes else None
    if width is not None and width != x.shape[0]:
        pad = x.new_zeros((width - x.shape[0],) + tuple(x.shape[1:]))
        x_p = torch.cat([x, pad])
    else:
        x_p = x
    if width == 0:
        _count(mesh, "all_gather", 0)
        parts = [x_p] * n
    else:
        buf = _wire(mesh, x_p)
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=mesh.group)
        _count(mesh, "all_gather", buf.numel() * buf.element_size())
        parts = [_unwire(mesh, p, x) for p in parts]
    if not tiled:
        return torch.stack(parts)
    if width is not None:
        parts = [p[:s] for p, s in zip(parts, sizes)]
    return torch.cat(parts)
