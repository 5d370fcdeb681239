"""The multilevel preconditioner: torch numerics + host orchestration.

Torch counterpart of hymls_tpu/core/preconditioner.py:

  * `initialize` partitions every level and builds the static plans on
    the host with the same numpy code as the reference (core/plan.py
    and partition/ are byte-identical copies), so both packages build
    identical plans;
  * `compute_fn(vals, dplans, extra)` maps the matrix value array to
    all factorizations of all levels: batched dense interior inverses,
    the Householder-transformed Schur assembly, the non-Vsum block
    inverses and the dense coarse factor; warm (`prev`: every dense
    inverse polished from the previous step's) and bordered
    (`border_vals`: the system [K V; W' C]);
  * `apply_fn(factors, aplans, b)` is the V-cycle.  By default
    ('Structured Apply' = "Auto", as in the reference) it is the
    gather-free structured apply of core/structured.py whenever its
    detection succeeds within the element budget; otherwise the
    generic apply: gathers + batched matvecs per level, the coarse
    solve at the bottom.  On CUDA tensors the apply of one factor tree
    is captured once as a CUDA graph and replayed (core/apply_graph.py).
    `apply_bordered_fn` is the bordered V-cycle, always on the generic
    plans.

Options, as in the reference: 'Number of Levels' = 0 eliminates the
interiors and solves the full Schur complement densely (`DirectSCPlan`);
'Apply Dropping' = false skips the Householder transform and keeps the
whole Schur complement per level; 'B-Grid Transform' builds everything
on M = T' K T and conjugates each apply with T (two DIA matvecs);
the 'Preconditioner Variant's live in the plans; 'Factor Precision' =
'f64' on an f32 preconditioner assembles in f64 and stores f32 factors.

The reference's sort/scatter permutation gathers (core/permute.py) are
TPU workarounds; here every static map is a plain index gather, which
the reference documents as bit-identical.  Index tensors are int64.
"""
from __future__ import annotations

import functools
import hashlib
import os
import pickle
import stat
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

import torch

from ..config import Params
from ..grid import GridInfo, grid_from_params
from ..partition.cartesian import CartesianPartitioner, PartitionParams
from ..partition.skew import SkewCartesianPartitioner
from ..partition.hierarchical import build_hierarchy
from .. import native as _native
from .plan import (LevelPlan, CoarsePlan, build_level_plan,
                   build_coarse_plan, SMALL_ENTRY)
from ..ops.spmv import DiaOperator
from ..utils.timings import count, prof
from .apply_graph import ApplyGraphs
from .structured import APPLY_LEVEL_SPANS
from .dense import (inv_newton as _inv, inv_chain as _inv_chain,
                    warm_inv as _warm_inv, warm_inv_chain as _warm_chain,
                    dense_factor as _dense_factor,
                    dense_solve as _dense_solve, _matmul)


# ---------------------------------------------------------------------------
# small tensor helpers
# ---------------------------------------------------------------------------

def _ext(v):
    """Append the 0.0 sentinel slot."""
    return torch.cat([v, v.new_zeros(1)])


def _pgather(dp, field, src_flat):
    """Static gather ``_ext(src_flat)[dp[field]]``."""
    return _ext(src_flat)[dp[field]]


def _bmm(A, x):
    """Batched matrix-vector: (s,m,n) @ (s,n) -> (s,m), dtype-promoting
    like dense._matmul."""
    return _matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _drop_rel_diag(vals, rows, cols, diag_entry, tol=SMALL_ENTRY):
    """RelDropDiag dropping as value-zeroing (pattern stays static):
    keep off-diagonal iff |v| > tol*max(|d_i|,|d_j|) and |v| > tol;
    diagonal uses the absolute criterion (reference
    HYMLS_MatrixUtils.cpp:1011-1151)."""
    diag = torch.abs(vals[diag_entry])
    scal = torch.maximum(diag[rows], diag[cols])
    av = torch.abs(vals)
    keep_off = (av > tol * scal) & (av > tol)
    keep = torch.where(rows == cols, av > tol, keep_off)
    return torch.where(keep, vals, torch.zeros_like(vals))


def _apply_ot(t, dp, enabled=True):
    """y = (2 W^T W - I) t — the global per-group Householder transform;
    groups without a reflector row get -I (reference
    HYMLS_Householder.cpp:353-363).  Gather form: each node belongs to
    at most one reflector row.  `enabled` False ('Apply Dropping' off:
    the plan holds no reflector at all) is that -I without the gathers."""
    if not enabled:
        return -t
    w_vals = dp["w_vals"]
    dots = torch.sum(w_vals * _ext(t)[dp["w_pos"]], dim=1)
    return 2.0 * _ext(w_vals.reshape(-1))[dp["ot_inv_idx"]] * \
        _ext(dots)[dp["ot_row_of"]] - t


# ---------------------------------------------------------------------------
# device plans (plain dicts of tensors)
# ---------------------------------------------------------------------------

LEVEL_FIELDS_INT = ("int_pos", "sd_sep_pos", "sep_pos_in_nodes",
                    "A11_idx", "A12_idx", "A21_idx", "A22_idx",
                    "w_pos", "sc22_src", "sc11_gather",
                    "blk_idx", "blk_pos", "vsum_pos", "next_idx",
                    "next_diag_entry", "next_rows", "next_cols",
                    "sep_from_sd", "ot_inv_idx", "ot_row_of",
                    "blk_inv_idx", "vsum_slot", "node_src")
LEVEL_FIELDS_BOOL = ("int_mask", "sd_sep_mask", "blk_mask")
LEVEL_FIELDS_FLOAT = ("Q", "w_vals")
COARSE_FIELDS = ("rows", "cols", "diag_entry", "fix_rows")

#: the subset of plan tensors the apply (V-cycle) reads
APPLY_FIELDS = ("int_pos", "sd_sep_pos", "sep_pos_in_nodes",
                "sep_from_sd", "blk_inv_idx", "blk_pos", "vsum_pos",
                "vsum_slot", "node_src", "w_vals", "w_pos",
                "ot_inv_idx", "ot_row_of")


def clamp_sentinels(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A level without non-Vsum blocks has an empty block solve, yet
    its `blk_inv_idx` sentinel is 1 (core/plan.py); the reference's
    gather clamps it onto the appended zero, a torch gather would raise.
    Clamp it there once, when the plan is built."""
    d["blk_inv_idx"] = d["blk_inv_idx"].clamp(max=d["blk_pos"].numel())
    return d


#: the extra maps of the vsum-restricted f64 assembly
SPLIT_FIELDS = ("vsum_col", "nxt22_v", "nxt11_v")


def _vsum_split_arrays(plan: LevelPlan):
    """Host-side derived maps for the vsum-restricted f64 assembly
    (_compute_level_split): per-subdomain Vsum column picks and the
    next-level gathers composed down to the compressed (s, nv, nv)
    Vsum blocks.  Returns None when any next-level entry reads a
    non-Vsum T slot (never observed; the reduced matrix is the
    Vsum-Vsum block by construction, reference
    HYMLS_SchurPreconditioner.cpp:520-629)."""
    sp_ = np.asarray(plan.sd_sep_pos)
    n_sd, ns = sp_.shape
    n_sep = plan.n_sep
    isv = np.zeros(n_sep + 1, bool)
    isv[np.asarray(plan.vsum_pos)] = True
    valid = (sp_ < n_sep) & isv[np.minimum(sp_, n_sep)]
    counts = valid.sum(axis=1)
    nv = max(int(counts.max()) if counts.size else 0, 1)
    vc = np.full((n_sd, nv), ns, np.int64)
    loc = np.full((n_sd, ns), nv, np.int64)
    for s in range(n_sd):
        cols = np.nonzero(valid[s])[0]
        vc[s, :cols.size] = cols
        loc[s, cols] = np.arange(cols.size)

    t_size = n_sd * ns * ns
    v_size = n_sd * nv * nv

    def compose(f):
        f = np.asarray(f, np.int64)
        sent = f >= t_size
        fc = np.where(sent, 0, f)
        s_i, rem = np.divmod(fc, ns * ns)
        i, j = np.divmod(rem, ns)
        a, b = loc[s_i, i], loc[s_i, j]
        if np.any(~sent & ((a >= nv) | (b >= nv))):
            return None
        return np.where(sent, v_size, s_i * (nv * nv) + a * nv + b)

    n22 = compose(np.asarray(plan.sc22_src)[plan.next_idx])
    n11 = compose(np.asarray(plan.sc11_gather)[plan.next_idx])
    if n22 is None or n11 is None:
        return None
    return {"vsum_col": vc, "nxt22_v": n22, "nxt11_v": n11}


def _device_level(plan: LevelPlan, dtype, device,
                  split_maps: bool = False) -> Dict[str, torch.Tensor]:
    """One level's static plan as tensors on `device`: index maps as
    int64, masks as bool, the dense transforms in `dtype` (the factor
    dtype).  `split_maps` adds the maps of the vsum-restricted f64
    assembly where the plan allows them."""
    d: Dict[str, torch.Tensor] = {}
    for f in LEVEL_FIELDS_INT:
        d[f] = torch.as_tensor(np.asarray(getattr(plan, f), dtype=np.int64),
                               device=device)
    for f in LEVEL_FIELDS_BOOL:
        d[f] = torch.as_tensor(np.asarray(getattr(plan, f), dtype=bool),
                               device=device)
    for f in LEVEL_FIELDS_FLOAT:
        d[f] = torch.as_tensor(np.asarray(getattr(plan, f)), dtype=dtype,
                               device=device)
    if split_maps:
        for k, v in (_vsum_split_arrays(plan) or {}).items():
            d[k] = torch.as_tensor(v, device=device)
    return clamp_sentinels(d)


def _device_coarse(cp: CoarsePlan, device) -> Dict[str, torch.Tensor]:
    return {f: torch.as_tensor(np.asarray(getattr(cp, f), dtype=np.int64),
                               device=device)
            for f in COARSE_FIELDS}


# ---------------------------------------------------------------------------
# per-level numerics
# ---------------------------------------------------------------------------

def _masked_eye(mask, dtype):
    """Identity rows for the padded slots of a batch of blocks: (s, m)
    mask of the real slots -> (s, m, m)."""
    eye = torch.eye(mask.shape[-1], dtype=dtype, device=mask.device)
    return eye[None] * (~mask)[:, :, None]


def _block_inverse(sc, dp, prev, dtype):
    """The non-Vsum block inverses of the assembled Schur values `sc`,
    inverted in `dtype`.  Exactly-zero rows (variables whose transformed
    couplings all vanish) get identity rows: the block solve passes
    their residual through instead of producing NaNs."""
    B = _pgather(dp, "blk_idx", sc)
    B = B + _masked_eye(dp["blk_mask"], B.dtype)
    zero_rows = torch.sum(torch.abs(B), dim=-1) == 0
    eye_b = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    B = (B + eye_b[None] * zero_rows[:, :, None]).to(dtype)
    return _inv(B) if prev is None else _warm_inv(B, prev["blkinv"])


def _assemble_sc(T22q, T11q, dp):
    """Schur values from the per-subdomain (transformed) blocks."""
    sc = _pgather(dp, "sc22_src", T22q.reshape(-1))
    return sc + torch.sum(_pgather(dp, "sc11_gather", T11q.reshape(-1)),
                          dim=1)


def _compute_level_split(vals, dp, apply_ot=True, store_dtype=None,
                         prev=None):
    """Factor one level with the Vsum-restricted f64 assembly ('Schur
    Assembly' = 'Vsum f64').

    The f64 arithmetic of the upcast chain protects one consumer: the
    next-level matrix values, where the recursive Schur cancellation
    amplifies rounding across levels.  Everything else the
    factorization produces (A11inv, G, A21, the non-Vsum block
    inverses) is cast to the apply dtype anyway.  So the full chain
    runs in `store_dtype` for the apply factors, and a small f64 side
    chain restricted to the Vsum columns (nv ~ groups per subdomain,
    below ns) gives the next-level values:

        Qv   = Q E_v                 (s, ns, nv)   one-hot column pick
        Z    = A11^{-1} (A12 Qv)     store-dtype inverse + one f64
                                     refinement step
        T11v = -(Qv' A21) Z          (s, nv, nv)
        T22v =  Qv' A22 Qv           (s, nv, nv)
        nxt  = drop(T22v[nxt22_v] + sum T11v[nxt11_v])

    The reference has the split to spare emulated f64 matmuls; the H100
    has native f64, and what the split costs or saves there is in
    PERF.md."""
    dtype = vals.dtype                       # f64 (upcast chain)
    f32 = store_dtype

    # f64 block gathers, shared by both chains
    A11 = _pgather(dp, "A11_idx", vals)
    A11 = A11 + _masked_eye(dp["int_mask"], dtype)
    A12 = _pgather(dp, "A12_idx", vals)
    A21 = _pgather(dp, "A21_idx", vals)
    A22 = _pgather(dp, "A22_idx", vals)

    # store-dtype chain: everything the apply consumes
    A11s, A12s, A21s, A22s = (x.to(f32) for x in (A11, A12, A21, A22))
    A11inv = _inv(A11s) if prev is None else _warm_inv(A11s,
                                                       prev["A11inv"])
    G = torch.matmul(A11inv, A12s)
    T11s = -torch.matmul(A21s, G)
    if apply_ot:
        Qs = dp["Q"].to(f32)
        T22q = torch.matmul(torch.matmul(Qs, A22s), Qs)
        T11q = torch.matmul(torch.matmul(Qs, T11s), Qs)
    else:
        T22q, T11q = A22s, T11s
    sc = _assemble_sc(T22q, T11q, dp)
    blkinv = _block_inverse(sc, dp, prev, f32)

    # f64 Vsum-restricted chain: the next-level values
    vc = dp["vsum_col"]                       # (s, nv), sentinel = ns
    ns = A22.shape[-1]
    Ev = (vc[:, None, :] == torch.arange(ns, device=vc.device)[None, :, None]
          ).to(dtype)                         # (s, ns, nv) one-hot
    Qv = torch.matmul(dp["Q"], Ev) if apply_ot else Ev
    Mv = torch.matmul(A12, Qv)                # (s, ni, nv)
    X64 = A11inv.to(dtype)
    Z0 = torch.matmul(X64, Mv)
    Z = Z0 + torch.matmul(X64, Mv - torch.matmul(A11, Z0))
    W = torch.matmul(A21, Z)                  # (s, ns, nv)
    QvT = Qv.transpose(1, 2)
    T11v = -torch.matmul(QvT, W)
    T22v = torch.matmul(QvT, torch.matmul(A22, Qv))

    nxt = _ext(T22v.reshape(-1))[dp["nxt22_v"]] + \
        torch.sum(_ext(T11v.reshape(-1))[dp["nxt11_v"]], dim=1)
    nxt = _drop_rel_diag(nxt, dp["next_rows"], dp["next_cols"],
                         dp["next_diag_entry"])
    factors = {"A11inv": A11inv, "G": G, "A21": A21s, "blkinv": blkinv,
               "sc": sc}
    return factors, nxt


def _compute_level(vals, dp, apply_ot=True, store_dtype=None, prev=None):
    """Factor one level: returns (factors dict, next-level values).

    `apply_ot` False ('Apply Dropping' off): the Schur blocks are
    assembled without the Householder conjugation.  With `prev`, the
    previous factor dict of this level (warm recompute), the dense
    inverses are Newton-Schulz-polished from their previous values
    (dense.warm_inv) instead of re-factored.

    `store_dtype` (factor upcast): the values chain (A11inv -> G -> T11
    -> sc -> next level) runs in vals.dtype (f64), because Schur
    cancellation amplifies rounding across levels, but the non-Vsum
    block inverse feeds only the apply and is inverted directly in the
    store dtype.  When the plan carries the vsum-split maps ('Schur
    Assembly' = 'Vsum f64') the f64 chain is restricted to the
    next-level entries instead: `_compute_level_split`."""
    if store_dtype is not None and "vsum_col" in dp:
        return _compute_level_split(vals, dp, apply_ot=apply_ot,
                                    store_dtype=store_dtype, prev=prev)
    dtype = vals.dtype
    A11 = _pgather(dp, "A11_idx", vals)
    A11 = A11 + _masked_eye(dp["int_mask"], dtype)
    if prev is None:
        A11inv = _inv(A11) if store_dtype is None else _inv_chain(A11)
    elif store_dtype is None:
        A11inv = _warm_inv(A11, prev["A11inv"])
    else:
        A11inv = _warm_chain(A11, prev["A11inv"])

    A12 = _pgather(dp, "A12_idx", vals)
    A21 = _pgather(dp, "A21_idx", vals)
    A22 = _pgather(dp, "A22_idx", vals)

    G = torch.matmul(A11inv, A12)               # (s, ni, ns)
    T11 = -torch.matmul(A21, G)                 # (s, ns, ns)
    if apply_ot:
        Q = dp["Q"]
        # Q symmetric: Q A Q^T == Q A Q
        T22q = torch.matmul(torch.matmul(Q, A22), Q)
        T11q = torch.matmul(torch.matmul(Q, T11), Q)
    else:
        T22q, T11q = A22, T11
    sc = _assemble_sc(T22q, T11q, dp)
    blkinv = _block_inverse(sc, dp, prev,
                            dtype if store_dtype is None else store_dtype)

    nxt = sc[dp["next_idx"]]
    nxt = _drop_rel_diag(nxt, dp["next_rows"], dp["next_cols"],
                         dp["next_diag_entry"])
    factors = {"A11inv": A11inv, "G": G, "A21": A21, "blkinv": blkinv,
               "sc": sc}
    return factors, nxt


def _coarse_factor(vals, rows, cols, diag_entry, fix_rows, n,
                   store_dtype=None, prev=None):
    """Dense coarse factorization (reference CoarseSolver::Compute:
    RelFullDiag drop + PutDirichlet + direct LU).  Under factor upcast
    the matrix is assembled and dropped in f64 and inverted in
    `store_dtype`.  With `prev` (warm recompute) an explicit inverse is
    polished from the previous one; LU factors (above 2048 unknowns)
    are recomputed cold."""
    A = _coarse_matrix(vals, rows, cols, diag_entry, fix_rows, n)
    if store_dtype is not None:
        A = A.to(store_dtype)
    if prev is not None and "inv" in prev:
        return {"inv": _warm_inv(A, prev["inv"])}
    return _dense_factor(A)


def _coarse_matrix(vals, rows, cols, diag_entry, fix_rows, n):
    """The dense coarse system: dropped values scattered into (n, n),
    Fix GID rows and columns replaced by identity."""
    dtype = vals.dtype
    vals = _drop_rel_diag(vals, rows, cols, diag_entry)
    A = torch.zeros((n, n), dtype=dtype, device=vals.device)
    A = A.index_put((rows, cols), vals, accumulate=True)
    return _pin_rows(A, fix_rows)


def _pin_rows(A, fix_rows):
    """Rows and columns `fix_rows` of A replaced by identity (Fix GID)."""
    if fix_rows.numel():
        keep = torch.ones(A.shape[0], dtype=A.dtype, device=A.device)
        keep[fix_rows] = 0.0
        A = A * keep[:, None] * keep[None, :]
        A[fix_rows, fix_rows] = 1.0
    return A


def _eliminate_interiors(b, fac, dp):
    """x1 = A11^{-1} b1 per subdomain and the separator residual
    r2 = b2 - A21 x1, summed over the subdomains that touch each
    separator node."""
    b1 = _pgather(dp, "int_pos", b)              # (s, ni)
    x1 = _bmm(fac["A11inv"], b1)
    y2c = _bmm(fac["A21"], x1)                   # (s, ns)
    y2 = torch.sum(_pgather(dp, "sep_from_sd", y2c.reshape(-1)), dim=1)
    return x1, _pgather(dp, "sep_pos_in_nodes", b) - y2


def _apply_level(b, fac, dp, solve_next, apply_ot=True):
    """One level of the preconditioner application (reference
    Preconditioner::ApplyInverse + SchurPreconditioner::ApplyInverse),
    all data movement gather-form."""
    x1, r2 = _eliminate_interiors(b, fac, dp)

    # --- Schur preconditioner -------------------------------------------
    t = _apply_ot(r2, dp, apply_ot)

    tb = _pgather(dp, "blk_pos", t)
    yb = _bmm(fac["blkinv"], tb)
    y = _pgather(dp, "blk_inv_idx", yb.reshape(-1))

    b_next = _pgather(dp, "vsum_pos", t)
    x_next = solve_next(b_next)
    n_vsum = dp["vsum_pos"].shape[0]
    y = torch.where(dp["vsum_slot"] < n_vsum,
                    _pgather(dp, "vsum_slot", x_next), y)

    x2 = _apply_ot(y, dp, apply_ot)

    # --- back substitution -------------------------------------------------
    x2sd = _pgather(dp, "sd_sep_pos", x2)
    x1 = x1 - _bmm(fac["G"], x2sd)

    src = torch.cat([x1.reshape(-1), x2])
    return _pgather(dp, "node_src", src)


# ---------------------------------------------------------------------------
# the bordered system [K V; W' C]
# ---------------------------------------------------------------------------

def _ext_rows(M):
    """Append the zero sentinel row to an (n, m) block."""
    return torch.cat([M, M.new_zeros((1, M.shape[1]))])


def _apply_ot_multi(t, dp, enabled=True):
    """`_apply_ot` on the columns of t (n_sep, m), gather form."""
    if not enabled:
        return -t
    w_vals = dp["w_vals"]
    dots = torch.sum(w_vals[:, :, None] * _ext_rows(t)[dp["w_pos"]], dim=1)
    w = _ext(w_vals.reshape(-1))[dp["ot_inv_idx"]]
    return 2.0 * w[:, None] * _ext_rows(dots)[dp["ot_row_of"]] - t


def _eliminate_border(fac, dp, V, W, C):
    """The interiors eliminated from the border of [K V; W' C]:
      Q1 = A11^{-1} V1;  SchurV = V2 - A21 Q1;
      SchurW = W2 - (A11^{-1} A12)^T W1;  C' = C - W1^T Q1.
    Returns (Q1, W1, SchurV, SchurW, C')."""
    m = V.shape[1]
    V1 = _ext_rows(V)[dp["int_pos"]]                 # (s, ni, m)
    W1 = _ext_rows(W)[dp["int_pos"]]
    Q1 = torch.matmul(fac["A11inv"], V1)

    def gather_sep(contrib):
        flat = _ext_rows(contrib.reshape(-1, m))
        return torch.sum(flat[dp["sep_from_sd"]], dim=1)

    sep = dp["sep_pos_in_nodes"]
    schurV = V[sep] - gather_sep(torch.matmul(fac["A21"], Q1))
    schurW = W[sep] - gather_sep(torch.matmul(fac["G"].transpose(1, 2), W1))
    Cp = C - W1.reshape(-1, m).T @ Q1.reshape(-1, m)
    return Q1, W1, schurV, schurW, Cp


def _compute_level_border(fac, dp, V, W, C, apply_ot=True):
    """Border propagation through one level (reference
    Preconditioner::ComputeBorder + SchurPreconditioner::ComputeBorder):
    `_eliminate_border`, then the Householder transform of SchurV and
    SchurW, whose Vsum rows are the next level's border.  Returns
    (border factors, V', W', C')."""
    Q1, W1, schurV, schurW, Cp = _eliminate_border(fac, dp, V, W, C)
    bV = _apply_ot_multi(schurV, dp, apply_ot)
    bW = _apply_ot_multi(schurW, dp, apply_ot)
    bfac = {"Q1": Q1, "W1": W1, "bW": bW}
    return bfac, bV[dp["vsum_pos"]], bW[dp["vsum_pos"]], Cp


def _augment(A, V, W, C):
    """The dense bordered matrix [A V; W' C]."""
    return torch.cat([torch.cat([A, V], dim=1), torch.cat([W.T, C], dim=1)])


def _coarse_factor_aug(vals, rows, cols, diag_entry, fix_rows, n, V, W, C,
                       store_dtype=None):
    """Bordered coarse factorization: the dense factor of [A V; W' C]
    (reference CoarseSolver::Compute + AugmentedMatrix).  `store_dtype`
    as in `_coarse_factor`."""
    Aug = _augment(_coarse_matrix(vals, rows, cols, diag_entry, fix_rows, n),
                   V, W, C)
    return _dense_factor(Aug if store_dtype is None else Aug.to(store_dtype))


def _apply_level_bordered(b, T, fac, dp, solve_next, apply_ot=True):
    """Bordered variant of `_apply_level` (reference
    Preconditioner::ApplyInverse(B,T,X,S) + the bordered
    SchurPreconditioner::ApplyInverse); `fac["border"]` holds the
    level's border factors.  Returns (x, S)."""
    bfac = fac["border"]
    x1, r2 = _eliminate_interiors(b, fac, dp)

    # border rhs: q = T - W1' x1
    W1 = bfac["W1"]
    q = T - _matmul(W1.reshape(-1, W1.shape[-1]).T, x1.reshape(-1))

    t = _apply_ot(r2, dp, apply_ot)
    yb = _bmm(fac["blkinv"], _pgather(dp, "blk_pos", t))
    y = _pgather(dp, "blk_inv_idx", yb.reshape(-1))

    # border correction with the non-Vsum part (Vsum entries of y are 0)
    Tc = q - _matmul(bfac["bW"].T, y)

    x_next, S = solve_next(_pgather(dp, "vsum_pos", t), Tc)
    n_vsum = dp["vsum_pos"].shape[0]
    y = torch.where(dp["vsum_slot"] < n_vsum,
                    _pgather(dp, "vsum_slot", x_next), y)
    x2 = _apply_ot(y, dp, apply_ot)

    x1 = x1 - _bmm(fac["G"], _pgather(dp, "sd_sep_pos", x2))
    x1 = x1 - _matmul(bfac["Q1"], S)
    src = torch.cat([x1.reshape(-1), x2])
    return _pgather(dp, "node_src", src), S


# ---------------------------------------------------------------------------
# L == 0: direct solve of the full (untransformed) Schur complement
# ---------------------------------------------------------------------------

DIRECT_FIELDS = ("a22_idx", "a22_rows", "a22_cols", "s11_rows", "s11_cols",
                 "s11_src", "fix_rows")


@dataclass
class DirectSCPlan:
    """Level plan variant when 'Number of Levels' == 0: eliminate the
    interiors, assemble the full Schur complement densely, solve it
    directly (reference Preconditioner::Compute at myLevel_ >=
    maxLevel_, HYMLS_Preconditioner.cpp:485-500)."""

    a22_idx: np.ndarray      # (m,) entries of K in sep x sep
    a22_rows: np.ndarray     # (m,) sep-local
    a22_cols: np.ndarray
    s11_rows: np.ndarray     # flat (sd, i, j) -> target (r, c)
    s11_cols: np.ndarray
    s11_src: np.ndarray
    fix_rows: np.ndarray


def build_direct_plan(K: sp.csr_matrix, plan: LevelPlan, sep_sorted,
                      fix_gids) -> DirectSCPlan:
    """The dense Schur complement's assembly maps (host): the entries of
    K within separators x separators, and all (i, j) pairs of each
    subdomain's separator nodes as targets of its -A21 A11^{-1} A12."""
    n = K.shape[0]
    n_sep = sep_sorted.size
    is_sep = np.zeros(n, dtype=bool)
    is_sep[sep_sorted] = True
    # entry index in CSR order == position in data (canonical CSR)
    csr_rows = np.repeat(np.arange(n), np.diff(K.indptr))
    csr_cols = K.indices
    msk = is_sep[csr_rows] & is_sep[csr_cols]
    a22_idx = np.arange(K.nnz, dtype=np.int64)[msk]
    a22_rows = np.searchsorted(sep_sorted, csr_rows[msk])
    a22_cols = np.searchsorted(sep_sorted, csr_cols[msk])

    ns = plan.sd_sep_pos.shape[1]
    rows_l, cols_l, src_l = [], [], []
    for sd in range(plan.sd_sep_pos.shape[0]):
        locs = plan.sd_sep_pos[sd][plan.sd_sep_mask[sd]]
        mloc = locs.size
        if mloc == 0:
            continue
        il = np.repeat(np.arange(mloc), mloc)
        jl = np.tile(np.arange(mloc), mloc)
        rows_l.append(np.repeat(locs, mloc))
        cols_l.append(np.tile(locs, mloc))
        src_l.append((sd * ns + il) * ns + jl)

    def cat(parts):
        return np.concatenate(parts) if parts else np.empty(0, np.int64)

    fix_local = []
    for gid in fix_gids:
        p = np.searchsorted(sep_sorted, gid)
        if p < n_sep and sep_sorted[p] == gid:
            fix_local.append(p)
    return DirectSCPlan(
        a22_idx=a22_idx, a22_rows=a22_rows, a22_cols=a22_cols,
        s11_rows=cat(rows_l), s11_cols=cat(cols_l), s11_src=cat(src_l),
        fix_rows=np.array(fix_local, dtype=np.int64))


def _direct_sc_matrix(vals, dsc, T11, n_sep):
    """Assemble the dense (pinned) Schur complement for L == 0."""
    S = torch.zeros((n_sep, n_sep), dtype=vals.dtype, device=vals.device)
    S = S.index_put((dsc["a22_rows"], dsc["a22_cols"]),
                    vals[dsc["a22_idx"]], accumulate=True)
    S = S.index_put((dsc["s11_rows"], dsc["s11_cols"]),
                    T11.reshape(-1)[dsc["s11_src"]], accumulate=True)
    return _pin_rows(S, dsc["fix_rows"])


def _compute_direct(vals, dp, ddirect, n_sep, border_vals=None, prev=None,
                    store_dtype=None):
    """Factor tree of the direct-Schur mode: {"levels": [{A11inv, G,
    A21}], "coarse": factor of the dense Schur complement}.  With
    `border_vals` the interiors are eliminated from [K V; W' C] and the
    coarse factor is that of the augmented Schur complement (reference
    CoarseSolver::SetBorder + AugmentedMatrix,
    HYMLS_CoarseSolver.cpp:200-224); "border" holds Q1 and W1.  `prev`
    and `store_dtype` as in `_compute_level`."""
    A11 = _pgather(dp, "A11_idx", vals)
    A11 = A11 + _masked_eye(dp["int_mask"], vals.dtype)
    if prev is None:
        A11inv = _inv(A11) if store_dtype is None else _inv_chain(A11)
    elif store_dtype is None:
        A11inv = _warm_inv(A11, prev["levels"][0]["A11inv"])
    else:
        A11inv = _warm_chain(A11, prev["levels"][0]["A11inv"])
    A12 = _pgather(dp, "A12_idx", vals)
    A21 = _pgather(dp, "A21_idx", vals)
    G = torch.matmul(A11inv, A12)
    S = _direct_sc_matrix(vals, ddirect, -torch.matmul(A21, G), n_sep)
    lev = {"A11inv": A11inv, "G": G, "A21": A21}
    fac = {"levels": [lev]}
    if border_vals is None:
        Ss = S if store_dtype is None else S.to(store_dtype)
        if prev is not None and "inv" in prev["coarse"]:
            fac["coarse"] = {"inv": _warm_inv(Ss, prev["coarse"]["inv"])}
        else:
            fac["coarse"] = _dense_factor(Ss)
        return fac
    Q1, W1, schurV, schurW, Cs = _eliminate_border(lev, dp, *border_vals)
    Maug = _augment(S, schurV, schurW, Cs)
    fac["coarse"] = _dense_factor(
        Maug if store_dtype is None else Maug.to(store_dtype))
    fac["border"] = {"Q1": Q1, "W1": W1}
    return fac


def _back_substitute(x1, x2, fac, dp):
    """x1 - G x2 on the interiors, then both parts in node order."""
    x1 = x1 - _bmm(fac["G"], _pgather(dp, "sd_sep_pos", x2))
    return _pgather(dp, "node_src", torch.cat([x1.reshape(-1), x2]))


def _apply_direct(factors, dp, b):
    """x = K^{-1} b through the dense Schur complement."""
    fac = factors["levels"][0]
    x1, r2 = _eliminate_interiors(b, fac, dp)
    return _back_substitute(x1, _dense_solve(factors["coarse"], r2), fac, dp)


def _apply_direct_bordered(factors, dp, b, t):
    """[x; s] = [K V; W' C]^{-1} [b; t] via the augmented dense Schur
    complement (reference CoarseSolver bordered ApplyInverse,
    HYMLS_CoarseSolver.cpp:454-564)."""
    fac = factors["levels"][0]
    bb = factors["border"]
    x1, r2 = _eliminate_interiors(b, fac, dp)
    W1 = bb["W1"]
    rt = t - _matmul(W1.reshape(-1, W1.shape[-1]).T, x1.reshape(-1))
    sol = _dense_solve(factors["coarse"], torch.cat([r2, rt]))
    n_sep = r2.shape[0]
    x2, s = sol[:n_sep], sol[n_sep:]
    x1 = x1 - _matmul(bb["Q1"], s)
    return _back_substitute(x1, x2, fac, dp), s


# ---------------------------------------------------------------------------
# the B-grid transform
# ---------------------------------------------------------------------------

def _build_bgrid_t(grid: GridInfo) -> sp.csr_matrix:
    """T rows: u -> (u - v)/sqrt(2), v -> (v + u)/sqrt(2); identity on
    all other variables (reference HYMLS_Preconditioner.cpp:1082-1112)."""
    n = grid.num_nodes
    dof = grid.dof
    val = np.sqrt(0.5)
    gid = np.arange(n, dtype=np.int64)
    var = gid % dof
    rows = [gid]
    cols = [gid]
    vals = [np.where(var <= 1, val, 1.0)]
    mu = var == 0
    rows.append(gid[mu])
    cols.append(gid[mu] + 1)
    vals.append(np.full(mu.sum(), -val))
    mv = var == 1
    rows.append(gid[mv])
    cols.append(gid[mv] - 1)
    vals.append(np.full(mv.sum(), val))
    T = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    T.sort_indices()
    return T


class _BGridConjugation:
    """x -> T apply(T' x) around any apply of a preconditioner built on
    M = T' K T: T and T' as DiaOperators (three bands each), so every
    apply costs two DIA matvecs more (two multi-column DIA products for
    a block of vectors).  The bands are gathered once per
    vector dtype (an f32 preconditioner inside an f64 Krylov method sees
    f64 vectors and promotes, as the reference does)."""

    def __init__(self, T: sp.csr_matrix, dtype, device):
        self.ops = (DiaOperator(T, dtype=dtype, device=device),
                    DiaOperator(T.T.tocsr(), dtype=dtype, device=device))
        self._bands = {}

    def __call__(self, apply, b):
        if b.dtype not in self._bands:
            self._bands[b.dtype] = tuple(
                op.prepare(op.vals).to(b.dtype) for op in self.ops)
        (Top, TopT), (bT, bTT) = self.ops, self._bands[b.dtype]
        y = apply(TopT.matvec_prepared(bTT, b.contiguous()))
        return Top.matvec_prepared(bT, y.contiguous())


# ---------------------------------------------------------------------------
# plan disk cache
# ---------------------------------------------------------------------------

#: host plan builds slower than this (seconds) are stored in the disk
#: cache, as in the reference; the test suite's many small builds are
#: not worth a file each
PLAN_CACHE_MIN_BUILD_S = 5.0

#: the plan-building sources, relative to the package: a change to any
#: of them invalidates every cached plan
_PLAN_SOURCES = ("core/plan.py", "core/preconditioner.py",
                 "partition/cartesian.py", "partition/skew.py",
                 "partition/hierarchical.py", "grid.py",
                 "native/__init__.py", "native/planner.cpp")


def _plan_cache_dir() -> str:
    """HYMLS_PLAN_CACHE, as in the reference (the empty string turns the
    cache off); by default a directory of this package's own under the
    temporary directory.  The two packages never share pickles: the
    reference's name hymls_tpu classes, and unpickling one would import
    JAX."""
    return os.environ.get(
        "HYMLS_PLAN_CACHE",
        os.path.join(tempfile.gettempdir(), "hymls_torch_plan_cache"))


@functools.lru_cache(maxsize=1)
def _plan_builder_salt() -> bytes:
    h = hashlib.sha256(b"hymls-torch-plan-cache-v1")
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in _PLAN_SOURCES:
        with open(os.path.join(base, rel), "rb") as f:
            h.update(f.read())
    return h.digest()


def _plan_cache_trusted(d: str) -> bool:
    """Whether the cache directory `d` is this user's own and writable by
    no one else.  Loading a pickle runs code, so a directory that another
    user created or may write into (a shared temporary directory, say)
    turns the cache off."""
    try:
        st = os.stat(d)
    except OSError:
        return False
    return (stat.S_ISDIR(st.st_mode) and st.st_uid == os.getuid()
            and not st.st_mode & (stat.S_IWGRP | stat.S_IWOTH))


def _plan_cache_load(key: Optional[str]):
    if key is None or not _plan_cache_trusted(_plan_cache_dir()):
        return None
    try:
        with open(os.path.join(_plan_cache_dir(), key + ".pkl"), "rb") as f:
            return pickle.load(f)
    except (OSError, pickle.PickleError, EOFError, AttributeError,
            ImportError):
        return None


def _plan_cache_store(key: Optional[str], payload) -> None:
    """Write atomically (a temporary file, then a rename), so that a
    process reading the cache never sees half a pickle; a failed write
    leaves no temporary file behind."""
    if key is None:
        return
    d = _plan_cache_dir()
    try:
        os.makedirs(d, mode=0o700, exist_ok=True)
        if not _plan_cache_trusted(d):
            return
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, os.path.join(d, key + ".pkl"))
        except BaseException:
            os.unlink(tmp)
            raise
    except (OSError, pickle.PickleError):
        pass


# ---------------------------------------------------------------------------
# Preconditioner
# ---------------------------------------------------------------------------

def _canonical(K: sp.spmatrix) -> sp.csr_matrix:
    K = K.tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K


def _cast_tree(t, src, dst):
    """The factor tree with every tensor of dtype `src` cast to `dst`."""
    if isinstance(t, dict):
        return {k: _cast_tree(v, src, dst) for k, v in t.items()}
    if isinstance(t, list):
        return [_cast_tree(v, src, dst) for v in t]
    return t.to(dst) if t.dtype == src else t


class Preconditioner:
    """Multilevel F-matrix preconditioner with the same math as the
    reference HYMLS::Preconditioner: any number of levels (0: the direct
    Schur solve), every 'Preconditioner Variant', with or without
    dropping; structured or generic apply."""

    def __init__(self, K: sp.csr_matrix, params: Params,
                 testvector: Optional[np.ndarray] = None,
                 dtype=torch.float64, factor_dtype=None, *, device):
        self.params = params
        self.dtype = dtype
        self.device = torch.device(device)
        prec = params.sublist("Preconditioner")
        # Factor (assembly) precision may exceed the apply precision:
        # 'Factor Precision' = 'f64' runs the factor pipeline of an f32
        # preconditioner in f64 and casts the factors to f32 (the
        # reference's analogue of doing all setup in double); on an f64
        # preconditioner it is 'Same'.
        if factor_dtype is None and dtype == torch.float32 and \
                prec.get("Factor Precision", "Same") == "f64":
            factor_dtype = torch.float64
        self.factor_dtype = dtype if factor_dtype is None else factor_dtype
        self._upcast = self.factor_dtype != self.dtype
        self.grid: GridInfo = grid_from_params(params)

        # B-grid transform: M = T' K T with T the 45-degree rotation of
        # each (u, v) velocity pair (reference Preconditioner::
        # TransformMatrix, HYMLS_Preconditioner.cpp:1072-1156); the
        # preconditioner is built on M and every apply is conjugated.
        self._bgrid_T = None
        self._bgrid = None
        if prec.get("B-Grid Transform", False):
            self._bgrid_T = _build_bgrid_t(self.grid)
            self._bgrid = _BGridConjugation(self._bgrid_T, dtype,
                                            self.device)
            K = self._transform_bgrid(K)
        self.K = _canonical(K.copy())
        n = self.K.shape[0]
        if n != self.grid.num_nodes:
            raise ValueError(
                f"matrix size {n} != grid size {self.grid.num_nodes}")

        self.max_level = prec.get("Number of Levels", 1)
        self.variant = prec.get("Preconditioner Variant", "Block Diagonal")
        self.partitioner_type = prec.get("Partitioner", "Cartesian")
        self.apply_dropping = prec.get("Apply Dropping", True)
        # 'Schur Assembly' under factor upcast: 'Vsum f64' restricts the
        # f64 chain to the next-level (Vsum) entries
        # (_compute_level_split), on the levels 'Vsum f64 Levels' names
        # (comma-separated, or 'all').  'Full f64' is the default.
        self._split_assembly = self._upcast and prec.get(
            "Schur Assembly", "Full f64") == "Vsum f64"
        lv = str(prec.get("Vsum f64 Levels", "all"))
        self._split_levels = None if lv.strip().lower() == "all" else {
            int(t) for t in lv.split(",") if t.strip()}

        fix_gids: List[int] = []
        pos = 1
        while f"Fix GID {pos}" in prec:
            fix_gids.append(prec[f"Fix GID {pos}"])
            pos += 1
        self.fix_gids = fix_gids

        if testvector is None:
            testvector = np.ones(n)
        self.testvector = np.asarray(testvector, dtype=np.float64)
        self._factors = None
        self._border = None
        self._graphs = ApplyGraphs()
        self.initialize()

    def _transform_bgrid(self, K: sp.csr_matrix) -> sp.csr_matrix:
        T = self._bgrid_T
        M = _canonical(T.T @ K.tocsr() @ T)
        # zero (keep the pattern static) instead of removing tiny entries
        M.data[np.abs(M.data) <= SMALL_ENTRY] = 0.0
        return M

    # -- symbolic setup ----------------------------------------------------
    def initialize(self):
        """Partition every level and build the static plans (host).

        The plans depend only on the matrix pattern, the test vector and
        the grid and preconditioner configuration, never on the values,
        so a build slower than `PLAN_CACHE_MIN_BUILD_S` is stored in a
        disk cache (`_plan_cache_dir`) under a hash of those inputs and
        of the plan-building sources, and later constructions load it
        (the reference's plan cache, hymls_tpu/core/preconditioner.py).
        `plan_from_cache` and `plan_seconds` say which happened and how
        long it took."""
        g = self.grid
        part = PartitionParams.from_params(self.params, g, level=0)
        pattern = self.K.copy()
        pattern.data = np.arange(pattern.nnz, dtype=np.int64)
        nodes = np.arange(g.num_nodes, dtype=np.int64)
        tv = self.testvector.copy()

        self.plans: List[LevelPlan] = []
        self.hierarchies = []
        self.coarse_plan: Optional[CoarsePlan] = None
        self.direct_plan: Optional[DirectSCPlan] = None
        self._level_parts: List[PartitionParams] = []
        t0 = time.perf_counter()
        key = None
        cached = None
        if self.max_level == 0:
            # the level-plan machinery for the elimination part, the
            # dense assembly maps for the rest
            cart = self._make_partitioner(part)
            sds = [cart.get_groups(sd) for sd in cart.valid_subdomain_ids()]
            hier = build_hierarchy(sds, active=None)
            plan, _ = build_level_plan(0, hier, pattern, nodes, tv)
            self.plans.append(plan)
            self.hierarchies.append(hier)
            self.direct_plan = build_direct_plan(
                self.K, plan, np.unique(hier.all_separator_nodes()),
                self.fix_gids)
        else:
            key = self._plan_cache_key()
            cached = _plan_cache_load(key)
        if cached is not None:
            (self.plans, self.hierarchies, self.coarse_plan,
             self._level_parts) = cached
        for lev in range(self.max_level if cached is None else 0):
            if lev > 0:
                # re-resolve per-level parameters and keep the
                # geometric separator-length evolution
                nxt = part.next_level()
                part = PartitionParams.from_params(self.params, g,
                                                   level=lev)
                part.sx, part.sy, part.sz = nxt.sx, nxt.sy, nxt.sz
                part.cx, part.cy, part.cz = nxt.cx, nxt.cy, nxt.cz
            cart = self._make_partitioner(part)
            self._level_parts.append(part)
            sds = [cart.get_groups(sd) for sd in cart.valid_subdomain_ids()]
            hier = build_hierarchy(sds, active=None if lev == 0 else nodes)
            plan, tv = build_level_plan(lev, hier, pattern, nodes, tv,
                                        apply_dropping=self.apply_dropping,
                                        variant=self.variant)
            self.plans.append(plan)
            self.hierarchies.append(hier)
            nodes = plan.next_nodes
            pattern = plan.next_pattern
        if self.max_level > 0 and cached is None:
            self.coarse_plan = build_coarse_plan(pattern, nodes,
                                                 self.fix_gids)
        self.plan_from_cache = cached is not None
        self.plan_seconds = time.perf_counter() - t0
        if cached is None and self.plan_seconds > PLAN_CACHE_MIN_BUILD_S:
            _plan_cache_store(key, (self.plans, self.hierarchies,
                                    self.coarse_plan, self._level_parts))
        self._build_device_plans()
        self._init_structured()
        return self

    def _plan_cache_key(self) -> Optional[str]:
        """Hash of everything the plan build reads; None when the cache
        is off (HYMLS_PLAN_CACHE='').  Unlike the reference's key it
        also says whether the native planner built the plans: the
        Python fallback orders the plan maps differently (equivalent
        plans, not identical ones)."""
        if not _plan_cache_dir():
            return None
        h = hashlib.sha256(_plan_builder_salt())
        h.update(np.asarray(self.K.indptr, np.int64).tobytes())
        h.update(np.asarray(self.K.indices, np.int64).tobytes())
        h.update(self.testvector.tobytes())
        # the per-level partition parameters, not the whole sublist: a
        # Teuchos-style get() inserts defaults, which would make the key
        # depend on what ran before
        parts = [repr(PartitionParams.from_params(self.params, self.grid,
                                                  level=lev))
                 for lev in range(self.max_level)]
        cfg = (repr(self.grid), self.max_level, self.variant,
               self.partitioner_type, self.apply_dropping,
               list(self.fix_gids), parts, _native.planner() is not None)
        h.update(repr(cfg).encode())
        return h.hexdigest()

    def _build_device_plans(self):
        """The plans as tensors: `_dplans` for the factorization (float
        fields in the factor dtype), `_aplans_gen`, the subset the
        generic apply reads (float fields in the apply dtype), and
        `_extra_plan`, the coarse plan or at L = 0 the direct plan."""
        self._dplans = [
            _device_level(p, self.factor_dtype, self.device,
                          split_maps=self._split_assembly and
                          (self._split_levels is None or
                           lev in self._split_levels))
            for lev, p in enumerate(self.plans)]
        self._aplans_gen = []
        for d in self._dplans:
            a = {k: d[k] for k in APPLY_FIELDS}
            a["w_vals"] = a["w_vals"].to(self.dtype)
            self._aplans_gen.append(a)
        self._dcoarse = self._ddirect = None
        if self.coarse_plan is not None:
            self._dcoarse = _device_coarse(self.coarse_plan, self.device)
        if self.direct_plan is not None:
            self._ddirect = {
                f: torch.as_tensor(np.asarray(getattr(self.direct_plan, f),
                                              dtype=np.int64),
                                   device=self.device)
                for f in DIRECT_FIELDS}
        self._extra_plan = self._ddirect if self.max_level == 0 \
            else self._dcoarse

    def _init_structured(self):
        """Build the gather-free structured apply (core/structured.py),
        or keep the generic gather path, as the reference decides
        (hymls_tpu/core/preconditioner.py:_init_structured).
        'Structured Apply' is False (generic), True (structured; raises
        if detection fails) or "Auto" (the default): structured unless
        detection fails or the repacked factor tensors would exceed the
        reference's element budget, 5e7 on the CPU and 3e7 elsewhere
        (the reference's TPU number; an H100 budget is not measured
        yet).  A fallback leaves its reason in `_structured_reason`.
        The direct-Schur mode has no levels to structure."""
        self._structured = None
        self._sfactors = None
        self._structured_reason = None
        if self.max_level == 0:
            self._structured_reason = "direct-SC mode"
            return
        mode = self.params.sublist("Preconditioner").get(
            "Structured Apply", "Auto")
        if mode is False:
            self._structured_reason = "disabled by parameter"
            return
        from .structured import build_structured_program
        if mode == "Auto":
            budget = 5e7 if self.device.type == "cpu" else 3e7
        else:
            budget = None
        self._structured = build_structured_program(self,
                                                    max_elements=budget)
        if self._structured is None and mode is True:
            raise ValueError(f"'Structured Apply' = true, but the "
                             f"structured apply does not fit this "
                             f"problem: {self._structured_reason}")

    def _make_partitioner(self, part: PartitionParams):
        if self.partitioner_type == "Skew Cartesian":
            return SkewCartesianPartitioner(self.grid, part)
        return CartesianPartitioner(self.grid, part)

    @property
    def _structured_active(self) -> bool:
        """Whether `apply_fn` runs the structured program.  Bordered
        applies keep the generic plans, as in the reference."""
        return self._structured is not None and self._border is None

    @property
    def _aplans(self):
        """The plan tree matching `apply_factors` and `apply_fn`: the
        structured program's constants, or the generic plans."""
        if self._structured_active:
            return self._structured.consts
        return self._aplans_gen

    # -- numerics (plain functions of their tensor arguments) ---------------
    def compute_fn(self, vals, dplans, extra, border_vals=None, prev=None):
        """Factor tree {"levels": [{A11inv, G, A21, blkinv, sc}, ...],
        "coarse": {"inv"} or {"lu", "piv"}} of the value array `vals`,
        assembled in the factor dtype and returned in this
        preconditioner's dtype.  `extra` is `_extra_plan`: the coarse
        plan, or at L = 0 the direct plan (the levels then hold A11inv,
        G and A21 only, see `_compute_direct`).

        `border_vals` (V, W, C): the bordered factorization; each level
        gains its border factors under "border" and the coarse factor
        is that of [A V; W' C].  `prev`, an earlier factor tree of the
        same pattern: the warm recompute (the reference's
        `recompute_fn`), every dense inverse polished from its previous
        value with a residual-gated cold fallback (dense.warm_inv)."""
        fdt = self.factor_dtype
        store = self.dtype if self._upcast else None
        v = vals.to(fdt)
        if border_vals is not None:
            border_vals = tuple(a.to(fdt) for a in border_vals)
        if self.max_level == 0:
            fac = _compute_direct(v, dplans[0], extra, self.plans[0].n_sep,
                                  border_vals, prev, store)
            return _cast_tree(fac, fdt, self.dtype) if self._upcast else fac
        ots = [p.apply_ot for p in self.plans]
        facs = []
        for lev in range(self.max_level):
            with prof(f"hymls.compute.L{lev}", 2):
                f, v = _compute_level(
                    v, dplans[lev], apply_ot=ots[lev], store_dtype=store,
                    prev=None if prev is None else prev["levels"][lev])
            facs.append(f)
        coarse_args = (v, extra["rows"], extra["cols"], extra["diag_entry"],
                       extra["fix_rows"], self.coarse_plan.n)
        if border_vals is None:
            with prof("hymls.compute.coarse", 2):
                coarse = _coarse_factor(
                    *coarse_args, store_dtype=store,
                    prev=None if prev is None else prev["coarse"])
        else:
            V, W, C = border_vals
            for lev in range(self.max_level):
                facs[lev]["border"], V, W, C = _compute_level_border(
                    facs[lev], dplans[lev], V, W, C, ots[lev])
            with prof("hymls.compute.coarse", 2):
                coarse = _coarse_factor_aug(*coarse_args, V, W, C,
                                            store_dtype=store)
        fac = {"levels": facs, "coarse": coarse}
        return _cast_tree(fac, fdt, self.dtype) if self._upcast else fac

    def apply_fn(self, factors, aplans, b):
        """x = M^{-1} b for the apply-side factor tree `factors` and the
        plan tree `aplans` (`apply_factors` and `_aplans`): the
        structured program when it is active, else the generic apply;
        conjugated with T under the B-grid transform.  `b` is a vector
        (n,) or a block (B, n) of vectors, one per row: a block runs
        the V-cycle once with a leading batch axis (the JAX package's
        `jax.vmap` of the apply), and T and T' as one multi-column DIA
        product each.  Inside the span `hymls.apply`, each level inside
        `hymls.apply.L<l>` and the coarse solve inside
        `hymls.apply.coarse`.

        On a CUDA `b` the apply of a factor tree is captured once as a
        CUDA graph and replayed (core/apply_graph.py): the same kernels,
        one launch from the host; the level and coarse spans then
        appear only at a capture.  `_apply_eager` is the apply without
        the graph, what the CPU always runs."""
        if b.device.type != "cuda":
            return self._apply_eager(factors, aplans, b)
        with prof("hymls.apply", 2):
            return self._graphs(self._apply_body, factors, aplans, b)

    def _apply_eager(self, factors, aplans, b):
        """`apply_fn` op by op, counted in `hymls.apply.eager`."""
        count("hymls.apply.eager")
        with prof("hymls.apply", 2):
            return self._apply_body(factors, aplans, b)

    def _apply_body(self, factors, aplans, b):
        if self._structured_active:
            def apply(v):
                return self._structured.apply(factors, v, aplans)
        else:
            def apply(v):
                return self._apply_levels(factors, aplans, v)
        return apply(b) if self._bgrid is None else self._bgrid(apply, b)

    def apply_generic(self, factors, dplans, b):
        """The generic gather V-cycle on a pruned generic factor tree
        (conjugated with T under the B-grid transform)."""
        def apply(v):
            return self._apply_levels(factors, dplans, v)
        return apply(b) if self._bgrid is None else self._bgrid(apply, b)

    def _apply_levels(self, factors, dplans, b):
        if b.dim() == 2:
            # a block, one vector per row: torch.func.vmap runs each op
            # of the V-cycle once for the block (GEMVs become GEMMs)
            return torch.func.vmap(
                lambda v: self._apply_levels(factors, dplans, v))(b) \
                .contiguous()
        if self.max_level == 0:
            return _apply_direct(factors, dplans[0], b)

        def solve_at(lev, rhs):
            if lev == self.max_level:
                with prof("hymls.apply.coarse", 3):
                    return _dense_solve(factors["coarse"], rhs)
            with prof(APPLY_LEVEL_SPANS[lev], 3):
                return _apply_level(rhs, factors["levels"][lev],
                                    dplans[lev],
                                    lambda r: solve_at(lev + 1, r),
                                    apply_ot=self.plans[lev].apply_ot)
        return solve_at(0, b)

    def apply_bordered_fn(self, factors, dplans, b, T):
        """[x; s] = [M V; W' C]^{-1} [b; T] on a pruned bordered factor
        tree and the generic plans; returns (x, s).  As in the
        reference, the bordered apply is not conjugated with the B-grid
        transform.  Blocks b (B, n) and T (B, m), one system per row,
        run the apply once with a leading batch axis, as `apply_fn`."""
        if b.dim() == 2:
            x, s = torch.func.vmap(
                lambda v, t: self.apply_bordered_fn(factors, dplans, v, t))(
                    b, T)
            return x.contiguous(), s.contiguous()
        if self.max_level == 0:
            return _apply_direct_bordered(factors, dplans[0], b, T)

        def solve_at(lev, rhs, Tc):
            if lev == self.max_level:
                sol = _dense_solve(factors["coarse"], torch.cat([rhs, Tc]))
                return sol[:rhs.shape[0]], sol[rhs.shape[0]:]
            return _apply_level_bordered(
                rhs, Tc, factors["levels"][lev], dplans[lev],
                lambda r, t: solve_at(lev + 1, r, t),
                apply_ot=self.plans[lev].apply_ot)
        return solve_at(0, b, T)

    # -- public API ----------------------------------------------------------
    def compute(self, K: Optional[sp.csr_matrix] = None):
        """Numeric factorization.  If K is given it must have the same
        pattern as the constructor matrix (reference
        Preconditioner::SetMatrix reuse semantics)."""
        return self._factorize(K, prev=None)

    def recompute(self, K: Optional[sp.csr_matrix] = None):
        """Warm value-only refactorization: `compute(K)` with every
        dense inverse Newton-Schulz-polished from the current factors
        (dense.warm_inv, with its residual-gated cold fallback).  The
        path for Newton and continuation loops whose successive
        matrices differ modestly.  Without factors yet, or with a
        border set, it computes cold."""
        warm = self._factors is not None and self._border is None
        return self._factorize(K, prev=self._factors if warm else None)

    def _factorize(self, K, prev):
        count("hymls.compute.calls")
        self._graphs.clear()
        with prof("hymls.compute", 1):
            if K is not None:
                if self._bgrid_T is not None:
                    K = self._transform_bgrid(K)
                K = _canonical(K)
                if K.nnz != self.K.nnz:
                    raise ValueError("matrix pattern changed")
                self.K = K
            vals = torch.as_tensor(self.K.data, dtype=self.factor_dtype,
                                   device=self.device)
            self._factors = self.compute_fn(vals, self._dplans,
                                            self._extra_plan, self._border,
                                            prev)
            if self._structured_active:
                with prof("hymls.compute.repack", 2):
                    self._sfactors = self.apply_factors_from(self._factors)
            else:
                self._sfactors = None
        return self

    def set_border(self, V, W=None, C=None):
        """Add a border [K V; W' C] to the whole hierarchy (reference
        Preconditioner::SetBorder): W=None means W = V, C=None means 0,
        and V=None removes the border.  The factors are recomputed at
        the next use; while a border is set the applies take the
        generic plans."""
        self._factors = None
        self._sfactors = None
        self._graphs.clear()
        if V is None:
            self._border = None
            return self
        V = np.asarray(V)
        if V.ndim == 1:
            V = V[:, None]
        W = V if W is None else np.asarray(W)
        if W.ndim == 1:
            W = W[:, None]
        m = V.shape[1]
        C = np.zeros((m, m)) if C is None else np.asarray(C)
        self._border = tuple(torch.as_tensor(a, dtype=self.factor_dtype,
                                             device=self.device)
                             for a in (V, W, C))
        return self

    @property
    def factors(self):
        if self._factors is None:
            self.compute()
        return self._factors

    @staticmethod
    def _prune_factors(factors):
        """Apply-side view of the factor tree (same tensors, no copies):
        the V-cycle reads A11inv/G/A21/blkinv (and the border factors,
        if any) per level and the coarse factor; the assembled Schur
        values are dropped."""
        keep = ("A11inv", "G", "A21", "blkinv", "border")
        out = {"levels": [{k: f[k] for k in keep if k in f}
                          for f in factors["levels"]],
               "coarse": factors["coarse"]}
        if "border" in factors:        # the direct-Schur mode's
            out["border"] = factors["border"]
        return out

    @property
    def apply_factors(self):
        """The factor tree `apply_fn` reads: repacked when the
        structured program is active, else the pruned generic tree."""
        factors = self.factors     # computes (and repacks) on first use
        if self._structured_active:
            return self._sfactors
        return self._prune_factors(factors)

    def apply_factors_from(self, factors):
        """The apply-side factor tree of an externally computed factor
        tree (e.g. a Newton step's re-factorization): repacked into the
        structured layout when that program is active."""
        pruned = self._prune_factors(factors)
        if self._structured_active:
            return self._structured.repack(pruned)
        return pruned

    def dump_levels(self, prefix: str = "level") -> list:
        """Write the level-0 matrix and every next-level matrix to
        MatrixMarket files `<prefix><level>.mtx`, assembled in f64 (the
        reference's dump_levels, after its HYMLS_STORE_MATRICES debug
        mode).  Returns the written paths."""
        from ..utils.io import write_matrix

        paths = [f"{prefix}0.mtx"]
        write_matrix(paths[0], self.K)
        f64 = torch.float64
        dplans = self._dplans if self.factor_dtype == f64 else [
            _device_level(p, f64, self.device) for p in self.plans]
        v = torch.as_tensor(self.K.data, dtype=f64, device=self.device)
        for lev in range(self.max_level):
            _f, v = _compute_level(v, dplans[lev],
                                   apply_ot=self.plans[lev].apply_ot)
            pat = self.plans[lev].next_pattern
            M = sp.csr_matrix((v.cpu().numpy(), pat.indices, pat.indptr),
                              shape=pat.shape)
            paths.append(f"{prefix}{lev + 1}.mtx")
            write_matrix(paths[-1], M)
        return paths

    def sharded_sapply_fn(self, mesh):
        """The structured apply with its box grids split over the ranks
        of `mesh` (core/structured.py ShardedApply), with the signature
        of `apply_fn`: sapply(sfactors, consts, b) -> x, the input and
        the output replicated on every rank (the reference's
        sharded_sapply_fn).  With the B-grid transform, T' before and T
        after it, replicated, through the same DIA operators as the
        single-process apply.  None without a structured program."""
        if self._structured is None:
            return None
        apply_sh = self._structured.sharded_apply_fn(mesh)

        def sapply(factors, consts, b):
            def apply(v):
                return apply_sh(factors, v, consts)
            return apply(b) if self._bgrid is None else self._bgrid(apply, b)
        return sapply

    def apply_inverse_fn(self):
        """(apply_fn, factors, plans) with apply_fn(factors, plans, b)
        -> x, computing first when there are no factors yet: what a
        solver needs to embed the apply in its own loop."""
        if self._factors is None:
            self.compute()
        return self.apply_fn, self.apply_factors, self._aplans

    def apply_inverse(self, b):
        """x = P^{-1} b for a single vector (tensor or numpy).  With a
        border set this solves with a zero border right-hand side
        (reference BorderedOperator ApplyInverse convention)."""
        b = torch.as_tensor(b, dtype=self.dtype, device=self.device)
        if self._border is not None:
            T = b.new_zeros(self._border[0].shape[1])
            return self.apply_inverse_bordered(b, T)[0]
        return self.apply_fn(self.apply_factors, self._aplans, b)

    def apply_inverse_bordered(self, b, t):
        """(x, s) = [P V; W' C]^{-1} [b; t]."""
        if self._border is None:
            raise ValueError("apply_inverse_bordered needs a border "
                             "(set_border)")
        return self.apply_bordered_fn(
            self.apply_factors, self._aplans_gen,
            torch.as_tensor(b, dtype=self.dtype, device=self.device),
            torch.as_tensor(t, dtype=self.dtype, device=self.device))
