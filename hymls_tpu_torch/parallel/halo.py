"""Halo-exchange DIA SpMV over a mesh.

Torch counterpart of hymls_tpu/parallel/halo.py (reference: the operator
apply communicates through Epetra_Import halo exchanges between
neighbouring ranks, src/HYMLS_Preconditioner.cpp:973-980).  The vector
is split into equal contiguous shards, one per rank; each rank receives
`halo` = max |offset| values from each ring neighbour (zeros at the two
ends of the non-periodic ring) and applies the band stencil locally.

The local product is one launch of the DIA kernel (ops/dia_spmv.py,
csrc/dia_spmv.cu on a card) on the padded shard [lo, x_l, hi], with the
band rows of the two halo stretches set to zero; the middle `local`
rows are kept.  The kernel's rule "x = 0 outside [0, n)" then touches
only discarded rows.
"""
from __future__ import annotations

import torch

from ..ops.dia_spmv import dia_matvec_packed
from ..ops.spmv import DiaOperator
from . import collectives as C


def dia_matvec_sharded(op: DiaOperator, mesh):
    """y_l = (A x)_l for this rank's shard: returns matvec(bands_l, x_l)
    with bands_l this rank's (k, n / ndev) columns of `op.prepare(vals)`
    (`local_bands`) and x_l its (n / ndev,) shard of x."""
    n = op.n
    ndev = mesh.size
    if n % ndev:
        raise ValueError(f"vector length {n} not divisible by {ndev}")
    local = n // ndev
    halo = max(abs(o) for o in op.offsets)
    if halo > local:
        raise ValueError("halo wider than shard")
    right = [(i, i + 1) for i in range(ndev - 1)]
    left = [(i, i - 1) for i in range(1, ndev)]

    def matvec(bands_l, x_l):
        if halo == 0:
            return dia_matvec_packed(bands_l, x_l, op.packed)
        lo = C.ppermute(mesh, x_l[-halo:], right, tag="dia_halo")
        hi = C.ppermute(mesh, x_l[:halo], left, tag="dia_halo")
        x_pad = torch.cat([lo, x_l, hi])        # a fresh contiguous tensor
        bands_pad = torch.nn.functional.pad(bands_l, (halo, halo))
        y = dia_matvec_packed(bands_pad, x_pad, op.packed)
        return y[halo:halo + local]

    return matvec


def local_bands(bands, mesh):
    """This rank's (k, n / ndev) columns of a prepared (k, n) band
    array, contiguous."""
    local = bands.shape[1] // mesh.size
    return bands[:, mesh.rank * local:(mesh.rank + 1) * local].contiguous()
