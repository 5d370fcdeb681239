"""Carry plans and factors from the JAX package into the port.

The reference `hymls_tpu.Preconditioner` keeps its device plans in
`_dplans` (one dict per level) and `_dcoarse`, and its factor tree as
{"levels": [{A11inv, G, A21, blkinv, sc}, ...], "coarse": {...}}.
With the structured apply active it also keeps the repacked tree
`_sfactors`, {"levels": [{A11, A21, G, blk: [...]}, ...], "coarse"}.
After `np.asarray` on each leaf these functions copy them into the
port's tensors, so that the port's applies can run on the reference's
own plans and factors.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

import torch

from .core.preconditioner import (LEVEL_FIELDS_INT, LEVEL_FIELDS_BOOL,
                                  LEVEL_FIELDS_FLOAT, COARSE_FIELDS,
                                  clamp_sentinels)


def plans_from_numpy(dplans: List[Dict[str, np.ndarray]],
                     dcoarse: Dict[str, np.ndarray], *, device):
    """(level plans, coarse plan) as the port's plan tensors: index maps
    int64 (sentinels clamped as the port's own plans are), masks bool,
    float fields in their own dtype.  The
    reference's gather-strategy arrays (`*_skeys`, `*_spos`, `*_ckeys`)
    are TPU workarounds and are dropped."""
    levels = []
    for d in dplans:
        t = {}
        for f in LEVEL_FIELDS_INT:
            t[f] = torch.tensor(np.asarray(d[f], dtype=np.int64),
                                device=device)
        for f in LEVEL_FIELDS_BOOL:
            t[f] = torch.tensor(np.asarray(d[f], dtype=bool),
                                device=device)
        for f in LEVEL_FIELDS_FLOAT:
            t[f] = torch.tensor(np.asarray(d[f]), device=device)
        levels.append(clamp_sentinels(t))
    coarse = {f: torch.tensor(np.asarray(dcoarse[f], dtype=np.int64),
                              device=device) for f in COARSE_FIELDS}
    return levels, coarse


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
