"""Carry plans and factors from the JAX package into the port.

The reference `hymls_tpu.Preconditioner` keeps, as the port does, its
device plans for the factorization (one dict per level), for the
generic apply (each level's pruned subset) and for the coarse solve
or, in the direct-Schur mode ('Number of Levels' = 0), the direct
solve; its factor tree as
{"levels": [{A11inv, G, A21, blkinv, sc}, ...], "coarse": {...}}
(direct-Schur mode: {"levels": [{A11inv, G, A21}], "coarse",
"border": {Q1, W1}}); and, with the structured apply active, the
repacked tree {"levels": [{A11, A21, G, blk: [...]}, ...], "coarse"}.
Under factor upcast ('Factor Precision' = 'f64' on an f32
preconditioner) the factorization plans hold f64 transforms and, with
'Schur Assembly' = 'Vsum f64', the split maps, while the factors and
the generic apply's plans are f32.
After `np.asarray` on each leaf these functions copy them into the
port's tensors, each leaf in its own dtype: the plans as the port's
`factor_plans` and `generic_plans`, a generic factor tree as the tree
that `Preconditioner.factors_of` wraps into the `Factors` value that
`apply_fn` reads, a repacked tree as the tree the port's structured
program applies.  So the port's applies can run on the reference's own
plans and factors.  The solvers hold no parameters; the one thing of
theirs that crosses is a deflation space with its correction system
(`deflation_from_numpy`).  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

import torch

from .core.preconditioner import (LEVEL_FIELDS_INT, LEVEL_FIELDS_BOOL,
                                  LEVEL_FIELDS_FLOAT, COARSE_FIELDS,
                                  SPLIT_FIELDS, DIRECT_FIELDS, APPLY_FIELDS,
                                  finish_level_plan)
from .solvers.deflation import Deflation


def _index_dict(d, fields, device):
    return {f: torch.tensor(np.asarray(d[f], dtype=np.int64), device=device)
            for f in fields}


def plans_from_numpy(dplans: List[Dict[str, np.ndarray]],
                     dcoarse: Optional[Dict[str, np.ndarray]] = None, *,
                     device):
    """(level plans, coarse plan) as the port's plan tensors: index maps
    int64 (finished as the port's own plans are: sentinels clamped,
    `ot_inv_idx` made into `ot_w`; the split maps where a level carries
    them), masks bool, float fields in their own dtype.  Works on the factorization plans and on the generic apply's
    pruned ones.  The coarse plan is None where `dcoarse` is (the
    direct-Schur mode).  The reference's gather-strategy arrays
    (`*_skeys`, `*_spos`, `*_ckeys`) are TPU workarounds and are
    dropped."""
    levels = []
    for d in dplans:
        ints = [f for f in LEVEL_FIELDS_INT + SPLIT_FIELDS if f in d]
        t = _index_dict(d, ints, device)
        for f in LEVEL_FIELDS_BOOL:
            if f in d:
                t[f] = torch.tensor(np.asarray(d[f], dtype=bool),
                                    device=device)
        for f in LEVEL_FIELDS_FLOAT:
            if f in d:
                t[f] = torch.tensor(np.asarray(d[f]), device=device)
        # `finish_level_plan` makes `ot_w` of `ot_inv_idx`
        missing = {"ot_inv_idx", *APPLY_FIELDS} - {"ot_w"} - set(t)
        if missing:
            raise ValueError(f"level plan lacks {sorted(missing)}")
        levels.append(finish_level_plan(t))
    coarse = None if dcoarse is None else _index_dict(dcoarse, COARSE_FIELDS,
                                                      device)
    return levels, coarse


def direct_plan_from_numpy(ddirect: Dict[str, np.ndarray], *, device):
    """The reference's `_ddirect` (direct-Schur mode) as the port's."""
    return _index_dict(ddirect, DIRECT_FIELDS, device)


def factors_from_numpy(factors, *, device):
    """A factor tree of numpy arrays (nested dicts and lists) as the
    same tree of tensors, each in its own dtype.  LU pivots (0-based
    swap indices in JAX) become torch's 1-based int32 pivots."""
    if isinstance(factors, dict):
        out = {k: factors_from_numpy(v, device=device)
               for k, v in factors.items() if k != "piv"}
        if "piv" in factors:
            out["piv"] = torch.tensor(
                np.asarray(factors["piv"], dtype=np.int32) + 1,
                device=device)
        return out
    if isinstance(factors, (list, tuple)):
        return [factors_from_numpy(v, device=device) for v in factors]
    return torch.tensor(np.asarray(factors), device=device)


SFACTOR_KEYS = ("A11", "A21", "G", "blk")


def sfactors_from_numpy(sfactors, *, device):
    """The reference's repacked (structured) factor tree, after
    `np.asarray` on each leaf, as the tree that
    `StructuredProgram.apply` of the port reads."""
    for lev, f in enumerate(sfactors["levels"]):
        if set(f) != set(SFACTOR_KEYS):
            raise ValueError(f"level {lev}: structured factors have keys "
                             f"{sorted(f)}, expected {list(SFACTOR_KEYS)}")
    return factors_from_numpy(sfactors, device=device)


def deflation_from_numpy(V, AV, ATV, R, D) -> Deflation:
    """The fields of the reference's `Deflation` (`Solver._deflation`
    after `setup_deflation`) as the port's, so that the port's deflated
    apply (`solvers.deflation.deflated_apply`) runs on the reference's
    own space and correction system.  Both keep them on the host."""
    return Deflation(*(np.array(a, dtype=np.float64)
                       for a in (V, AV, ATV, R, D)))
