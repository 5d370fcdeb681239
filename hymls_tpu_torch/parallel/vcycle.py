"""The all-gather V-cycle: per-rank subdomain elimination with the
separator stage replicated.

Torch counterpart of hymls_tpu/parallel/vcycle.py, the reference's
simple distributed apply (reference MPI layout,
src/HYMLS_Preconditioner.cpp:930-1070 + HYMLS_BasePartitioner.cpp:
361-586): each rank owns a block of the batched factor arrays (A11inv,
G, A21 and the per-subdomain index plans); the per-subdomain
elimination and back substitution run rank-local, and the separator /
Schur stage runs replicated after one `all_gather` per level and
direction.  A level whose subdomain count the mesh does not divide runs
replicated.  Vectors are global on every rank; the halo V-cycle
(halo_vcycle.py) is the apply whose level path needs no all_gather.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.dense import dense_solve as _dense_solve
from ..core.preconditioner import _apply_ot, _bmm, _pgather
from . import collectives as C

_SHARDED_FACTOR_KEYS = ("A11inv", "G", "A21")
_SHARDED_PLAN_KEYS = ("int_pos", "sd_sep_pos")


def _sharded_levels(precond, ndev):
    return [p.int_pos.shape[0] % ndev == 0 for p in precond.plans]


def shard_factors(precond, mesh):
    """(factors, plans) of this rank: on every level whose subdomain
    count divides the mesh, its block of the per-subdomain factor and
    plan arrays; everything else whole."""
    factors = precond.factors.pruned
    aplans = precond.generic_plans
    ndev, r = mesh.size, mesh.rank
    fac_out, pl_out = [], []
    for sh, fac, dp in zip(_sharded_levels(precond, ndev),
                           factors["levels"], aplans):
        B = fac["A11inv"].shape[0] // ndev
        cut = slice(r * B, (r + 1) * B)
        fac_out.append({k: (v[cut] if sh and k in _SHARDED_FACTOR_KEYS
                            else v) for k, v in fac.items()})
        pl_out.append({k: (v[cut] if sh and k in _SHARDED_PLAN_KEYS else v)
                       for k, v in dp.items()})
    return {"levels": fac_out, "coarse": factors["coarse"]}, pl_out


def make_sharded_apply(precond, mesh) -> Callable:
    """apply(factors, aplans, b) -> x with (factors, aplans) from
    `shard_factors`: the V-cycle with the per-subdomain work split over
    the ranks and the separator contributions and interior solutions
    all-gathered (the reference's Export-with-Add and Import)."""
    sharded = _sharded_levels(precond, mesh.size)
    ots = [p.apply_ot for p in precond.plans]
    max_level = precond.max_level

    def level_fn(lev, b, factors, aplans):
        fac, dp, sh = factors["levels"][lev], aplans[lev], sharded[lev]
        x1 = _bmm(fac["A11inv"], _pgather(dp, "int_pos", b))
        y2c = _bmm(fac["A21"], x1)
        if sh:
            y2c = C.all_gather(mesh, y2c)
        y2 = torch.sum(_pgather(dp, "sep_from_sd", y2c.reshape(-1)), dim=1)
        t = _apply_ot(_pgather(dp, "sep_pos_in_nodes", b) - y2, dp, ots[lev])
        yb = _bmm(fac["blkinv"], _pgather(dp, "blk_pos", t))
        y = _pgather(dp, "blk_inv_idx", yb.reshape(-1))
        rhs = _pgather(dp, "vsum_pos", t)
        x_next = _dense_solve(factors["coarse"], rhs) \
            if lev + 1 == max_level else \
            level_fn(lev + 1, rhs, factors, aplans)
        n_vsum = dp["vsum_pos"].shape[0]
        y = torch.where(dp["vsum_slot"] < n_vsum,
                        _pgather(dp, "vsum_slot", x_next), y)
        x2 = _apply_ot(y, dp, ots[lev])
        x1 = x1 - _bmm(fac["G"], _pgather(dp, "sd_sep_pos", x2))
        if sh:
            x1 = C.all_gather(mesh, x1)
        return _pgather(dp, "node_src", torch.cat([x1.reshape(-1), x2]))

    def apply(factors, aplans, b):
        return level_fn(0, b, factors, aplans)

    return apply
