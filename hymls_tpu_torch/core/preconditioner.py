"""The multilevel preconditioner: torch numerics + host orchestration.

Torch counterpart of the block-diagonal, L >= 1 path of
hymls_tpu/core/preconditioner.py:

  * `initialize` partitions every level and builds the static plans on
    the host with the same numpy code as the reference (core/plan.py
    and partition/ are byte-identical copies), so both packages build
    identical plans;
  * `compute_fn(vals, dplans, dcoarse)` maps the matrix value array to
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
    solve at the bottom.  `apply_bordered_fn` is the bordered V-cycle,
    always on the generic plans.

The reference's sort/scatter permutation gathers (core/permute.py) are
TPU workarounds; here every static map is a plain index gather, which
the reference documents as bit-identical.  Index tensors are int64.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

import torch

from ..config import Params
from ..grid import GridInfo, grid_from_params
from ..partition.cartesian import CartesianPartitioner, PartitionParams
from ..partition.skew import SkewCartesianPartitioner
from ..partition.hierarchical import build_hierarchy
from .plan import (LevelPlan, CoarsePlan, build_level_plan,
                   build_coarse_plan, SMALL_ENTRY)
from .dense import (inv_newton as _inv, warm_inv as _warm_inv,
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


def _apply_ot(t, dp):
    """y = (2 W^T W - I) t — the global per-group Householder transform;
    groups without a reflector row get -I (reference
    HYMLS_Householder.cpp:353-363).  Gather form: each node belongs to
    at most one reflector row."""
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


def _device_level(plan: LevelPlan, dtype, device) -> Dict[str, torch.Tensor]:
    """One level's static plan as tensors on `device`: index maps as
    int64, masks as bool, the dense transforms in `dtype`."""
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
    return clamp_sentinels(d)


def _device_coarse(cp: CoarsePlan, device) -> Dict[str, torch.Tensor]:
    return {f: torch.as_tensor(np.asarray(getattr(cp, f), dtype=np.int64),
                               device=device)
            for f in COARSE_FIELDS}


# ---------------------------------------------------------------------------
# per-level numerics
# ---------------------------------------------------------------------------

def _compute_level(vals, dp, prev=None):
    """Factor one level: returns (factors dict, next-level values).
    With `prev`, the previous factor dict of this level (warm
    recompute), the dense inverses are Newton-Schulz-polished from
    their previous values (dense.warm_inv) instead of re-factored."""
    dtype = vals.dtype
    A11 = _pgather(dp, "A11_idx", vals)
    ni = A11.shape[-1]
    eye_i = torch.eye(ni, dtype=dtype, device=vals.device)
    A11 = A11 + eye_i[None] * (~dp["int_mask"])[:, :, None]
    A11inv = _inv(A11) if prev is None else _warm_inv(A11, prev["A11inv"])

    A12 = _pgather(dp, "A12_idx", vals)
    A21 = _pgather(dp, "A21_idx", vals)
    A22 = _pgather(dp, "A22_idx", vals)

    G = torch.matmul(A11inv, A12)               # (s, ni, ns)
    T11 = -torch.matmul(A21, G)                 # (s, ns, ns)
    Q = dp["Q"]
    # Q symmetric: Q A Q^T == Q A Q
    T22q = torch.matmul(torch.matmul(Q, A22), Q)
    T11q = torch.matmul(torch.matmul(Q, T11), Q)

    sc = _pgather(dp, "sc22_src", T22q.reshape(-1))
    sc = sc + torch.sum(_pgather(dp, "sc11_gather", T11q.reshape(-1)),
                        dim=1)

    B = _pgather(dp, "blk_idx", sc)
    mb = B.shape[-1]
    eye_b = torch.eye(mb, dtype=dtype, device=vals.device)
    B = B + eye_b[None] * (~dp["blk_mask"])[:, :, None]
    # exactly-zero rows (variables whose transformed couplings all
    # vanish) get identity rows: the block solve passes their residual
    # through instead of producing NaNs
    zero_rows = torch.sum(torch.abs(B), dim=-1) == 0
    B = B + eye_b[None] * zero_rows[:, :, None]
    blkinv = _inv(B) if prev is None else _warm_inv(B, prev["blkinv"])

    nxt = sc[dp["next_idx"]]
    nxt = _drop_rel_diag(nxt, dp["next_rows"], dp["next_cols"],
                         dp["next_diag_entry"])
    factors = {"A11inv": A11inv, "G": G, "A21": A21, "blkinv": blkinv,
               "sc": sc}
    return factors, nxt


def _coarse_factor(vals, rows, cols, diag_entry, fix_rows, n, prev=None):
    """Dense coarse factorization (reference CoarseSolver::Compute:
    RelFullDiag drop + PutDirichlet + direct LU).  With `prev` (warm
    recompute) an explicit inverse is polished from the previous one;
    LU factors (above 2048 unknowns) are recomputed cold."""
    A = _coarse_matrix(vals, rows, cols, diag_entry, fix_rows, n)
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
    if fix_rows.numel():
        keep = torch.ones(n, dtype=dtype, device=vals.device)
        keep[fix_rows] = 0.0
        A = A * keep[:, None] * keep[None, :]
        A[fix_rows, fix_rows] = 1.0
    return A


def _apply_level(b, fac, dp, solve_next):
    """One level of the block-diagonal preconditioner application
    (reference Preconditioner::ApplyInverse +
    SchurPreconditioner::ApplyInverse), all data movement gather-form."""
    b1 = _pgather(dp, "int_pos", b)              # (s, ni)
    x1 = _bmm(fac["A11inv"], b1)

    y2c = _bmm(fac["A21"], x1)                   # (s, ns)
    y2 = torch.sum(_pgather(dp, "sep_from_sd", y2c.reshape(-1)), dim=1)

    b2 = _pgather(dp, "sep_pos_in_nodes", b)
    r2 = b2 - y2

    # --- Schur preconditioner -------------------------------------------
    t = _apply_ot(r2, dp)

    tb = _pgather(dp, "blk_pos", t)
    yb = _bmm(fac["blkinv"], tb)
    y = _pgather(dp, "blk_inv_idx", yb.reshape(-1))

    b_next = _pgather(dp, "vsum_pos", t)
    x_next = solve_next(b_next)
    n_vsum = dp["vsum_pos"].shape[0]
    y = torch.where(dp["vsum_slot"] < n_vsum,
                    _pgather(dp, "vsum_slot", x_next), y)

    x2 = _apply_ot(y, dp)

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


def _apply_ot_multi(t, dp):
    """`_apply_ot` on the columns of t (n_sep, m), gather form."""
    w_vals = dp["w_vals"]
    dots = torch.sum(w_vals[:, :, None] * _ext_rows(t)[dp["w_pos"]], dim=1)
    w = _ext(w_vals.reshape(-1))[dp["ot_inv_idx"]]
    return 2.0 * w[:, None] * _ext_rows(dots)[dp["ot_row_of"]] - t


def _compute_level_border(fac, dp, V, W, C):
    """Border propagation through one level (reference
    Preconditioner::ComputeBorder + SchurPreconditioner::ComputeBorder):
      Q1 = A11^{-1} V1;  SchurV = V2 - A21 Q1;
      SchurW = W2 - (A11^{-1} A12)^T W1;  C' = C - W1^T Q1;
    then the Householder transform of SchurV and SchurW, whose Vsum rows
    are the next level's border.  Returns (border factors, V', W', C')."""
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
    bV = _apply_ot_multi(schurV, dp)
    bW = _apply_ot_multi(schurW, dp)
    bfac = {"Q1": Q1, "W1": W1, "bW": bW}
    return bfac, bV[dp["vsum_pos"]], bW[dp["vsum_pos"]], Cp


def _coarse_factor_aug(vals, rows, cols, diag_entry, fix_rows, n, V, W, C):
    """Bordered coarse factorization: the dense factor of [A V; W' C]
    (reference CoarseSolver::Compute + AugmentedMatrix)."""
    A = _coarse_matrix(vals, rows, cols, diag_entry, fix_rows, n)
    return _dense_factor(torch.cat([torch.cat([A, V], dim=1),
                                    torch.cat([W.T, C], dim=1)]))


def _apply_level_bordered(b, T, fac, dp, solve_next):
    """Bordered variant of `_apply_level` (reference
    Preconditioner::ApplyInverse(B,T,X,S) + the bordered
    SchurPreconditioner::ApplyInverse); `fac["border"]` holds the
    level's border factors.  Returns (x, S)."""
    bfac = fac["border"]
    b1 = _pgather(dp, "int_pos", b)
    x1 = _bmm(fac["A11inv"], b1)

    y2c = _bmm(fac["A21"], x1)
    y2 = torch.sum(_pgather(dp, "sep_from_sd", y2c.reshape(-1)), dim=1)
    r2 = _pgather(dp, "sep_pos_in_nodes", b) - y2

    # border rhs: q = T - W1' x1
    W1 = bfac["W1"]
    q = T - _matmul(W1.reshape(-1, W1.shape[-1]).T, x1.reshape(-1))

    t = _apply_ot(r2, dp)
    yb = _bmm(fac["blkinv"], _pgather(dp, "blk_pos", t))
    y = _pgather(dp, "blk_inv_idx", yb.reshape(-1))

    # border correction with the non-Vsum part (Vsum entries of y are 0)
    Tc = q - _matmul(bfac["bW"].T, y)

    x_next, S = solve_next(_pgather(dp, "vsum_pos", t), Tc)
    n_vsum = dp["vsum_pos"].shape[0]
    y = torch.where(dp["vsum_slot"] < n_vsum,
                    _pgather(dp, "vsum_slot", x_next), y)
    x2 = _apply_ot(y, dp)

    x1 = x1 - _bmm(fac["G"], _pgather(dp, "sd_sep_pos", x2))
    x1 = x1 - _matmul(bfac["Q1"], S)
    src = torch.cat([x1.reshape(-1), x2])
    return _pgather(dp, "node_src", src), S


# ---------------------------------------------------------------------------
# Preconditioner
# ---------------------------------------------------------------------------

def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to hymls_tpu_torch yet (ROADMAP {item})")


class Preconditioner:
    """Multilevel F-matrix preconditioner with the same math as the
    reference HYMLS::Preconditioner (block-diagonal variant, one or
    more levels; structured or generic apply)."""

    def __init__(self, K: sp.csr_matrix, params: Params,
                 testvector: Optional[np.ndarray] = None,
                 dtype=torch.float64, *, device):
        self.params = params
        self.dtype = dtype
        self.device = torch.device(device)
        prec = params.sublist("Preconditioner")
        self.max_level = prec.get("Number of Levels", 1)
        self.variant = prec.get("Preconditioner Variant", "Block Diagonal")
        self.partitioner_type = prec.get("Partitioner", "Cartesian")
        self.apply_dropping = prec.get("Apply Dropping", True)
        if self.max_level < 1:
            raise _unsupported("'Number of Levels' = 0 (direct Schur "
                               "solve)", "M9")
        if self.variant != "Block Diagonal":
            raise _unsupported(f"'Preconditioner Variant' = "
                               f"{self.variant!r}", "M9")
        if not self.apply_dropping:
            raise _unsupported("'Apply Dropping' = false", "M9")
        if prec.get("B-Grid Transform", False):
            raise _unsupported("'B-Grid Transform'", "M9")
        if prec.get("Factor Precision", "Same") == "f64":
            raise _unsupported("'Factor Precision' = 'f64'", "M9")
        self.grid: GridInfo = grid_from_params(params)
        K = K.tocsr().copy()
        K.sum_duplicates()
        K.sort_indices()
        self.K = K
        n = K.shape[0]
        if n != self.grid.num_nodes:
            raise ValueError(
                f"matrix size {n} != grid size {self.grid.num_nodes}")

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
        self.initialize()

    # -- symbolic setup ----------------------------------------------------
    def initialize(self):
        """Partition every level and build the static plans (host)."""
        g = self.grid
        part = PartitionParams.from_params(self.params, g, level=0)
        pattern = self.K.copy()
        pattern.data = np.arange(pattern.nnz, dtype=np.int64)
        nodes = np.arange(g.num_nodes, dtype=np.int64)
        tv = self.testvector.copy()

        self.plans: List[LevelPlan] = []
        self.hierarchies = []
        self._level_parts: List[PartitionParams] = []
        for lev in range(self.max_level):
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
        self.coarse_plan: CoarsePlan = build_coarse_plan(pattern, nodes,
                                                         self.fix_gids)
        self._dplans = [_device_level(p, self.dtype, self.device)
                        for p in self.plans]
        self._dcoarse = _device_coarse(self.coarse_plan, self.device)
        self._init_structured()
        return self

    def _init_structured(self):
        """Build the gather-free structured apply (core/structured.py),
        or keep the generic gather path, as the reference decides
        (hymls_tpu/core/preconditioner.py:_init_structured).
        'Structured Apply' is False (generic), True (structured; raises
        if detection fails) or "Auto" (the default): structured unless
        detection fails or the repacked factor tensors would exceed the
        reference's element budget, 5e7 on the CPU and 3e7 elsewhere
        (the reference's TPU number; an H100 budget is not measured
        yet).  A fallback leaves its reason in `_structured_reason`."""
        self._structured = None
        self._sfactors = None
        self._structured_reason = None
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
    def _aplans_gen(self):
        """The plan tensors the generic apply reads (a pruned view, no
        copies)."""
        return [{k: d[k] for k in APPLY_FIELDS} for d in self._dplans]

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
    def compute_fn(self, vals, dplans, dcoarse, border_vals=None,
                   prev=None):
        """Factor tree {"levels": [{A11inv, G, A21, blkinv, sc}, ...],
        "coarse": {"inv"} or {"lu", "piv"}} of the value array `vals`,
        computed in this preconditioner's dtype.

        `border_vals` (V, W, C): the bordered factorization; each level
        gains its border factors under "border" and the coarse factor
        is that of [A V; W' C].  `prev`, an earlier factor tree of the
        same pattern: the warm recompute (the reference's
        `recompute_fn`), every dense inverse polished from its previous
        value with a residual-gated cold fallback (dense.warm_inv)."""
        v = vals.to(self.dtype)
        facs = []
        for lev in range(self.max_level):
            f, v = _compute_level(
                v, dplans[lev], None if prev is None else prev["levels"][lev])
            facs.append(f)
        coarse_args = (v, dcoarse["rows"], dcoarse["cols"],
                       dcoarse["diag_entry"], dcoarse["fix_rows"],
                       self.coarse_plan.n)
        if border_vals is None:
            coarse = _coarse_factor(
                *coarse_args, prev=None if prev is None else prev["coarse"])
        else:
            V, W, C = (a.to(self.dtype) for a in border_vals)
            for lev in range(self.max_level):
                facs[lev]["border"], V, W, C = _compute_level_border(
                    facs[lev], dplans[lev], V, W, C)
            coarse = _coarse_factor_aug(*coarse_args, V, W, C)
        return {"levels": facs, "coarse": coarse}

    def apply_fn(self, factors, aplans, b):
        """x = M^{-1} b for the apply-side factor tree `factors` and the
        plan tree `aplans` (`apply_factors` and `_aplans`): the
        structured program when it is active, else the generic apply."""
        if self._structured_active:
            return self._structured.apply(factors, b, aplans)
        return self.apply_generic(factors, aplans, b)

    def apply_generic(self, factors, dplans, b):
        """The generic gather V-cycle on a pruned generic factor tree."""
        def solve_at(lev, rhs):
            if lev == self.max_level:
                return _dense_solve(factors["coarse"], rhs)
            return _apply_level(rhs, factors["levels"][lev], dplans[lev],
                                lambda r: solve_at(lev + 1, r))
        return solve_at(0, b)

    def apply_bordered_fn(self, factors, dplans, b, T):
        """[x; s] = [M V; W' C]^{-1} [b; T] on a pruned bordered factor
        tree and the generic plans; returns (x, s)."""
        def solve_at(lev, rhs, Tc):
            if lev == self.max_level:
                sol = _dense_solve(factors["coarse"], torch.cat([rhs, Tc]))
                return sol[:rhs.shape[0]], sol[rhs.shape[0]:]
            return _apply_level_bordered(
                rhs, Tc, factors["levels"][lev], dplans[lev],
                lambda r, t: solve_at(lev + 1, r, t))
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
        if K is not None:
            K = K.tocsr()
            K.sum_duplicates()
            K.sort_indices()
            if K.nnz != self.K.nnz:
                raise ValueError("matrix pattern changed")
            self.K = K
        vals = torch.as_tensor(self.K.data, dtype=self.dtype,
                               device=self.device)
        self._factors = self.compute_fn(vals, self._dplans, self._dcoarse,
                                        self._border, prev)
        self._sfactors = (self.apply_factors_from(self._factors)
                          if self._structured_active else None)
        return self

    def set_border(self, V, W=None, C=None):
        """Add a border [K V; W' C] to the whole hierarchy (reference
        Preconditioner::SetBorder): W=None means W = V, C=None means 0,
        and V=None removes the border.  The factors are recomputed at
        the next use; while a border is set the applies take the
        generic plans."""
        self._factors = None
        self._sfactors = None
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
        self._border = tuple(torch.as_tensor(a, dtype=self.dtype,
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
        return {"levels": [{k: f[k] for k in keep if k in f}
                           for f in factors["levels"]],
                "coarse": factors["coarse"]}

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
