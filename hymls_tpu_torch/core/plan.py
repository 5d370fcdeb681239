"""Static per-level index plans for the multilevel preconditioner.

This is where the reference's dynamic, communication-heavy setup
(MatrixBlock extraction, Ifpack containers, FECrsMatrix assembly —
reference src/HYMLS_MatrixBlock.cpp, src/HYMLS_SchurPreconditioner.cpp)
becomes a TPU-native design: since the grid, partitioning and group
structure are fully static, ALL indexing is precomputed on the host
once.  The numeric phase (core/preconditioner.py) is then a pure
composition of gathers, batched dense algebra, and segment-sums over
these plans — jittable end to end, with the subdomain axis as the
natural sharding axis.

Conventions:
  * every gather index array indexes an "extended" value vector with
    one trailing sentinel slot holding 0.0; `sentinel == len(values)`.
  * all positions are int32 local indices (into the level's node list
    or separator list), padded with the corresponding sentinel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..partition.hierarchical import Hierarchy
from .. import native as _native

SMALL_ENTRY = 1e-14  # reference HYMLS_Macros.hpp:26-30


# ---------------------------------------------------------------------------
# CSR helpers
# ---------------------------------------------------------------------------

class CsrLookup:
    """Batched (row, col) -> data-index lookup over a canonical CSR.
    A native O(1) hash over the composite keys is built once (the plan
    builder issues ~1e8 queries per level at 32^3-skew sizes); numpy
    searchsorted over the sorted key array is the fallback."""

    def __init__(self, A: sp.csr_matrix):
        self.nnz = A.nnz
        n = A.shape[1]
        self._n = n
        row_of = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                           np.diff(A.indptr))
        self.keys = row_of * n + A.indices.astype(np.int64)
        self._hash = _native.CsrHash.build(self.keys) \
            if self.keys.size else None

    def query(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        q = rows.astype(np.int64) * self._n + cols.astype(np.int64)
        if self.keys.size == 0:
            return np.full(q.shape, self.nnz, dtype=np.int64)
        if self._hash is not None and q.size >= 4096:
            return self._hash.lookup(q, self.nnz)
        pos = np.searchsorted(self.keys, q)
        ok = (pos < self.keys.size) & \
            (self.keys[np.minimum(pos, self.keys.size - 1)] == q)
        return np.where(ok, pos, self.nnz).astype(np.int64)

    def query_block(self, R: np.ndarray, C: np.ndarray,
                    row_limit: Optional[int] = None,
                    col_limit: Optional[int] = None) -> np.ndarray:
        """Outer-product lookup: out[b, i, j] = entry id of
        (R[b, i], C[b, j]).  The native path forms the composite keys
        in-register — the (B, nr, nc) broadcast array (~1 GB at
        32^3-skew plan sizes) is never materialized — and skips
        probing for padded ids >= row_limit/col_limit."""
        if self.keys.size and self._hash is not None \
                and R.shape[0] * R.shape[1] * C.shape[1] >= 4096:
            return self._hash.lookup_block(R, C, self._n, self.nnz,
                                           row_limit, col_limit)
        return self.query(R[:, :, None], C[:, None, :])


def csr_entry_ids(A: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray
                  ) -> np.ndarray:
    """One-shot convenience wrapper around CsrLookup."""
    return CsrLookup(A).query(rows, cols)


def _locate(sorted_arr: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """Positions of gids in a sorted array (gids must all be present)."""
    pos = _native.locate_sorted(sorted_arr, gids) \
        if np.asarray(gids).size >= 16384 else None
    if pos is None:
        pos = np.searchsorted(sorted_arr, gids)
    assert gids.size == 0 or np.all(sorted_arr[pos] == gids), \
        "GID not found in level node set"
    return pos.astype(np.int64)


def _pad2(arrs: List[np.ndarray], width: int, fill) -> np.ndarray:
    out = np.full((len(arrs), width), fill, dtype=np.asarray(
        arrs[0] if arrs else np.zeros(1, dtype=np.int64)).dtype)
    for i, a in enumerate(arrs):
        out[i, :len(a)] = a
    return out


def _round_up(x: int, m: int = 1) -> int:
    # NOTE: measured on TPU v5e, the Krylov loop is bound by re-streaming
    # the factor arrays each iteration (~11.5 GB/s effective), so padded
    # bytes cost linearly; exact sizes beat MXU-tile rounding.
    return max(((x + m - 1) // m) * m, m)


def _invert_to_padded(targets: np.ndarray, srcs: np.ndarray,
                      n_targets: int, sentinel: int) -> np.ndarray:
    """Build the gather-form inverse of a scatter: for each target, the
    padded list of source indices (TPU scatters are serialized; padded
    gathers + sum are vectorized)."""
    targets = np.asarray(targets, dtype=np.int64)
    srcs = np.asarray(srcs, dtype=np.int64)
    if targets.size == 0:
        return np.full((n_targets, 1), sentinel, dtype=np.int64)
    if targets.size >= 16384:
        out = _native.invert_to_padded(targets, srcs, n_targets, sentinel)
        if out is not None:
            return out
    order = np.argsort(targets, kind="stable")
    t_sorted = targets[order]
    s_sorted = srcs[order]
    counts = np.bincount(t_sorted, minlength=n_targets)
    max_c = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(targets.size) - starts[t_sorted]
    out = np.full((n_targets, max_c), sentinel, dtype=np.int64)
    out[t_sorted, rank] = s_sorted
    return out


# ---------------------------------------------------------------------------
# Householder reflectors (host construction)
# ---------------------------------------------------------------------------

def make_reflector(v: np.ndarray) -> Optional[np.ndarray]:
    """Unit reflector w for test-vector segment v, such that
    Q = 2 w w' - I rotates v onto its first coordinate.  Returns None
    when the transform degenerates (reference semantics: sign(v[0])==0
    disables the group's reflector — src/HYMLS_Householder.cpp:128-163;
    the sparse OT then acts as -I on the group while the dense
    RestrictedOT acts as +I; both are replicated faithfully)."""
    sigma = np.sign(v[0])
    if sigma == 0.0:
        return None
    u = sigma * v
    u[0] += np.linalg.norm(v)
    nrm = np.linalg.norm(u)
    if nrm < SMALL_ENTRY:
        return None
    return u / nrm


# ---------------------------------------------------------------------------
# Level plan
# ---------------------------------------------------------------------------

@dataclass
class LevelPlan:
    """All static indexing for one reduction level."""

    level: int
    n_nodes: int                 # active nodes at this level
    n_sep: int                   # separator nodes
    nnz: int                     # nnz of this level's matrix pattern
    nnz_sc: int                  # nnz of the (dropped) transformed SC

    # interior / separator geometry
    int_pos: np.ndarray          # (n_sd, ni) positions into node vector
    int_mask: np.ndarray         # (n_sd, ni) bool
    sd_sep_pos: np.ndarray       # (n_sd, ns) positions into sep vector
    sd_sep_mask: np.ndarray      # (n_sd, ns) bool
    sep_pos_in_nodes: np.ndarray  # (n_sep,) positions of seps in node vector

    # matrix block gathers (into vals_ext of this level's matrix)
    A11_idx: np.ndarray          # (n_sd, ni, ni)
    A12_idx: np.ndarray          # (n_sd, ni, ns)
    A21_idx: np.ndarray          # (n_sd, ns, ni)
    A22_idx: np.ndarray          # (n_sd, ns, ns)

    # dense orthogonal transform per subdomain, and global reflectors
    Q: np.ndarray                # (n_sd, ns, ns) float
    w_vals: np.ndarray           # (n_refl, gmax) float
    w_pos: np.ndarray            # (n_refl, gmax) positions into sep vector

    # Schur-complement assembly
    sc22_src: np.ndarray         # (nnz_sc,) flat index into T22 (no sent.)
    sc11_src: np.ndarray         # (n_contrib,) flat index into T11
    sc11_seg: np.ndarray         # (n_contrib,) target entry in [0, nnz_sc)

    # non-Vsum dense blocks
    blk_idx: np.ndarray          # (n_blk, m, m) indices into sc_vals_ext
    blk_pos: np.ndarray          # (n_blk, m) positions into sep vector
    blk_mask: np.ndarray         # (n_blk, m) bool

    # Vsum (next level) structure
    vsum_pos: np.ndarray         # (n_vsum,) positions into sep vector,
                                 # ordered by ascending vsum GID
    next_idx: np.ndarray         # (nnz_next,) indices into sc_vals
    next_diag_entry: np.ndarray  # (n_vsum,) entry id of (i,i) in next CSR
    next_rows: np.ndarray        # (nnz_next,) local row ids of next matrix
    next_cols: np.ndarray        # (nnz_next,)

    # inverse (gather-form) maps: TPU scatters are serialized, so every
    # scatter in the apply path is transposed into a padded gather
    sep_from_sd: np.ndarray      # (n_sep, max_c) flat idx into (s,ns)+sent
    ot_inv_idx: np.ndarray       # (n_sep,) flat idx into w_vals (+sent)
    ot_row_of: np.ndarray        # (n_sep,) reflector row (+sent)
    blk_inv_idx: np.ndarray      # (n_sep,) flat idx into (n_blk, mb) (+sent)
    vsum_slot: np.ndarray        # (n_sep,) position in next vector (+sent)
    node_src: np.ndarray         # (n_nodes,) idx into concat(x1.flat, x2)
    sc11_gather: np.ndarray      # (nnz_sc, max_c11) flat idx into T11 (+sent)

    # bookkeeping for the next level
    next_nodes: np.ndarray       # sorted vsum GIDs
    apply_ot: bool = True        # False: no transform/drop at this level
    next_pattern: Optional[sp.csr_matrix] = None  # index CSR of next matrix


def build_level_plan(level: int,
                     hier: Hierarchy,
                     pattern: sp.csr_matrix,
                     nodes: np.ndarray,
                     testvector: np.ndarray,
                     apply_dropping: bool = True,
                     variant: str = "Block Diagonal"
                     ) -> Tuple[LevelPlan, np.ndarray]:
    """Build the static plan for one level.

    Args:
      hier: filtered/deduplicated ordering for this level.
      pattern: this level's matrix pattern as an *index CSR* over local
        node ids (data[i] == i).
      nodes: sorted active GIDs (defines local ids).
      testvector: test vector values over `nodes`.

    Returns (plan, next_testvector over plan.next_nodes)."""
    n_sd = hier.num_subdomains
    nloc = {"nodes": nodes}

    sep_sorted = np.unique(hier.all_separator_nodes())
    n_sep = sep_sorted.size
    sep_pos_in_nodes = _locate(nodes, sep_sorted)

    # --- per-subdomain geometry -----------------------------------------
    int_locs = [_locate(nodes, hier.interior[sd]) for sd in range(n_sd)]
    sep_gids_sd = [hier.sep_nodes_of_sd(sd) for sd in range(n_sd)]
    sep_locs_sd = [_locate(sep_sorted, g) for g in sep_gids_sd]
    # separator locs in the *node* vector (for matrix extraction)
    sep_nlocs_sd = [_locate(nodes, g) for g in sep_gids_sd]

    ni = _round_up(max((len(a) for a in int_locs), default=1))
    ns = _round_up(max((len(a) for a in sep_locs_sd), default=1))

    int_pos = _pad2(int_locs, ni, nodes.size)
    int_mask = int_pos < nodes.size
    sd_sep_pos = _pad2(sep_locs_sd, ns, n_sep)
    sd_sep_mask = sd_sep_pos < n_sep

    # --- matrix block gathers --------------------------------------------
    nnz = pattern.nnz
    lookup = CsrLookup(pattern)

    def block_idx(rows_list, cols_list, nr, nc):
        # padded batched lookup: out-of-range row/col sentinels make the
        # query miss and map to the nnz (zero) slot
        fill = pattern.shape[0]
        R = _pad2(rows_list, nr, fill) if rows_list else \
            np.full((n_sd, nr), fill, dtype=np.int64)
        C = _pad2(cols_list, nc, fill) if cols_list else \
            np.full((n_sd, nc), fill, dtype=np.int64)
        return lookup.query_block(R, C, row_limit=pattern.shape[0],
                                  col_limit=pattern.shape[1])

    sep_nlocs_arr = sep_nlocs_sd
    A11_idx = block_idx(int_locs, int_locs, ni, ni)
    A12_idx = block_idx(int_locs, sep_nlocs_arr, ni, ns)
    A21_idx = block_idx(sep_nlocs_arr, int_locs, ns, ni)
    A22_idx = block_idx(sep_nlocs_arr, sep_nlocs_arr, ns, ns)

    # --- orthogonal transform ---------------------------------------------
    tv_nodes = testvector
    groups = hier.groups
    n_groups = len(groups)
    reflectors: List[Optional[np.ndarray]] = []
    group_locs: List[np.ndarray] = []
    for g in groups:
        locs = _locate(nodes, g.nodes)
        group_locs.append(_locate(sep_sorted, g.nodes))
        v = tv_nodes[locs]
        reflectors.append(make_reflector(v.copy())
                          if apply_dropping else None)

    gmax = _round_up(max((g.nodes.size for g in groups), default=1))
    refl_list = [(w, gl) for w, gl in zip(reflectors, group_locs)
                 if w is not None]
    n_refl = len(refl_list)
    w_vals = np.zeros((max(n_refl, 1), gmax))
    w_pos = np.full((max(n_refl, 1), gmax), n_sep, dtype=np.int64)
    for i, (w, gl) in enumerate(refl_list):
        w_vals[i, :w.size] = w
        w_pos[i, :w.size] = gl

    # dense per-subdomain Q (identity pad; per-group 2ww'-I, or identity
    # for degenerate groups, matching the dense RestrictedOT)
    group_index = {int(g.nodes[0]): gi for gi, g in enumerate(groups)}
    Q = np.zeros((n_sd, ns, ns))
    Q[:, np.arange(ns), np.arange(ns)] = 1.0
    if apply_dropping:
        for sd in range(n_sd):
            off = 0
            for gi in hier.sd_groups[sd]:
                ln = groups[gi].nodes.size
                w = reflectors[gi]
                if w is not None:
                    Q[sd, off:off + ln, off:off + ln] = \
                        2.0 * np.outer(w, w) - np.eye(ln)
                off += ln

    # --- transformed & dropped SC pattern + assembly sources ---------------
    # Enumerate contributions per subdomain: all Vsum-Vsum pairs plus all
    # intra-linked-set non-Vsum pairs (reference
    # HYMLS_SchurPreconditioner.cpp:736-786, 877-986).
    rows_all: List[np.ndarray] = []
    cols_all: List[np.ndarray] = []
    srcs_all: List[np.ndarray] = []
    for sd in range(n_sd):
        gis = hier.sd_groups[sd]
        if not gis:
            continue
        if not apply_dropping:
            # full SC: all pairs of the subdomain's separator nodes
            # (reference SchurComplement::Construct /
            # SchurPreconditioner::Assemble)
            locs = sep_locs_sd[sd]
            mloc = locs.size
            rr = np.repeat(locs, mloc)
            cc = np.tile(locs, mloc)
            il = np.repeat(np.arange(mloc), mloc)
            jl = np.tile(np.arange(mloc), mloc)
            rows_all.append(rr)
            cols_all.append(cc)
            srcs_all.append((sd * ns + il) * ns + jl)
            continue
        offs = np.cumsum([0] + [groups[gi].nodes.size for gi in gis])[:-1]
        # Vsum-Vsum: local offset of each group's first node
        v_loc = offs
        v_row = np.array([group_locs[gi][0] for gi in gis])
        rr = np.repeat(v_row, len(gis))
        cc = np.tile(v_row, len(gis))
        il = np.repeat(v_loc, len(gis))
        jl = np.tile(v_loc, len(gis))
        rows_all.append(rr)
        cols_all.append(cc)
        srcs_all.append((sd * ns + il) * ns + jl)

        # per-sd linked sets (types are cell-position codes, identical in
        # every subdomain that sees the group — link by unique-group type)
        by_type: List[List[int]] = []
        for pos_in_sd, gi in enumerate(gis):
            t = groups[gi].type
            placed = False
            if t >= 0:
                for s in by_type:
                    if groups[s[0][1]].type == t:
                        s.append((pos_in_sd, gi))
                        placed = True
                        break
            if not placed:
                by_type.append([(pos_in_sd, gi)])
        for lset in by_type:
            locs = []
            slocs = []
            for pos_in_sd, gi in lset:
                ln = groups[gi].nodes.size
                if ln <= 1:
                    continue
                locs.append(group_locs[gi][1:])
                slocs.append(offs[pos_in_sd] + 1 + np.arange(ln - 1))
            if not locs:
                continue
            locs = np.concatenate(locs)
            slocs = np.concatenate(slocs)
            m = locs.size
            rr = np.repeat(locs, m)
            cc = np.tile(locs, m)
            il = np.repeat(slocs, m)
            jl = np.tile(slocs, m)
            rows_all.append(rr)
            cols_all.append(cc)
            srcs_all.append((sd * ns + il) * ns + jl)

    if rows_all:
        rows_cat = np.concatenate(rows_all)
        cols_cat = np.concatenate(cols_all)
        srcs_cat = np.concatenate(srcs_all)
    else:
        rows_cat = np.empty(0, dtype=np.int64)
        cols_cat = cols_cat = np.empty(0, dtype=np.int64)
        srcs_cat = np.empty(0, dtype=np.int64)

    # unique entries (sorted by (row, col) over separator-local ids)
    keys = rows_cat * n_sep + cols_cat
    uniq_keys, seg = np.unique(keys, return_inverse=True)
    nnz_sc = uniq_keys.size
    sc_rows = uniq_keys // max(n_sep, 1)
    sc_cols = uniq_keys % max(n_sep, 1)

    # canonical (first in enumeration order) source for the A22 part
    first = np.full(nnz_sc, -1, dtype=np.int64)
    # np.unique returns first occurrence when we process in order:
    order = np.argsort(seg, kind="stable")
    seg_sorted = seg[order]
    starts = np.searchsorted(seg_sorted, np.arange(nnz_sc))
    first = order[starts]
    sc22_src = srcs_cat[first]
    sc11_src = srcs_cat
    sc11_seg = seg

    # --- non-Vsum blocks (owned linked sets) -------------------------------
    sc_pat = sp.csr_matrix(
        (np.arange(nnz_sc, dtype=np.int64), (sc_rows, sc_cols)),
        shape=(max(n_sep, 1), max(n_sep, 1)))
    sc_pat.sort_indices()
    # re-derive entry ids after canonicalization
    sc_lookup = sc_pat.copy()

    blocks: List[np.ndarray] = []
    if apply_dropping and variant == "Do Nothing":
        # reference clears the block solvers for this variant
        # (HYMLS_SchurPreconditioner.cpp:250-253): the non-Vsum part of
        # the preconditioned vector is left at zero.
        pass
    elif apply_dropping and variant == "Domain Decomposition":
        # one solver for all non-Vsum nodes (reference
        # InitializeSingleBlock, HYMLS_SchurPreconditioner.cpp:342-382)
        locs = [group_locs[gi][1:] for gi in range(n_groups)
                if groups[gi].nodes.size > 1]
        if locs:
            blocks.append(np.concatenate(locs))
    else:
        # 'Block Diagonal', 'Lower Triangular' and 'Upper Triangular'
        # all use the linked-set blocks.  The reference's triangular
        # sweeps (HYMLS_SchurPreconditioner.cpp:1054-1066,1374-1433)
        # run B - S*Y block by block against the transformed+DROPPED
        # matrix, whose non-Vsum rows only retain couplings inside
        # their own linked set (plus Vsum columns, which are zero
        # during the sweep) -- so on the retained pattern the sweeps
        # are numerically identical to the block-diagonal apply, and
        # we batch all blocks on the MXU instead of serialising them.
        for lset in (hier.linked_sets if apply_dropping else []):
            locs = [group_locs[gi][1:] for gi in lset
                    if groups[gi].nodes.size > 1]
            if not locs:
                continue
            blocks.append(np.concatenate(locs))
    n_blk = len(blocks)
    mb = _round_up(max((b.size for b in blocks), default=1))
    blk_pos = _pad2(blocks, mb, n_sep) if blocks else \
        np.full((0, mb), n_sep, dtype=np.int64)
    blk_mask = blk_pos < n_sep
    blk_idx = np.full((n_blk, mb, mb), nnz_sc, dtype=np.int64)
    sc_lu = CsrLookup(sc_lookup)
    for b, locs in enumerate(blocks):
        m = locs.size
        rr = np.repeat(locs, m)
        cc = np.tile(locs, m)
        blk_idx[b, :m, :m] = sc_lu.query(rr, cc).reshape(m, m)

    # --- Vsum / next level --------------------------------------------------
    if apply_dropping:
        vsum_gids = hier.vsum_nodes()
        order_v = np.argsort(vsum_gids)
        next_nodes = vsum_gids[order_v]
        vsum_sep_loc = np.array(
            [group_locs[gi][0] for gi in range(n_groups)], dtype=np.int64)
        vsum_pos = vsum_sep_loc[order_v]
    else:
        # no dropping: every separator node goes to the next level
        # (reference CreateVSumMap with applyDropping_ == false)
        next_nodes = sep_sorted.copy()
        vsum_sep_loc = np.arange(n_sep, dtype=np.int64)
        vsum_pos = np.arange(n_sep, dtype=np.int64)

    # next-level pattern: all SC entries with both endpoints Vsums
    vsum_mask_sep = np.zeros(max(n_sep, 1), dtype=bool)
    vsum_mask_sep[vsum_sep_loc] = True
    is_next = vsum_mask_sep[sc_rows] & vsum_mask_sep[sc_cols]
    next_idx = np.nonzero(is_next)[0].astype(np.int64)
    # map separator-local ids -> next-level local ids
    sep_to_next = np.full(max(n_sep, 1), -1, dtype=np.int64)
    sep_to_next[vsum_pos] = np.arange(next_nodes.size)
    next_rows = sep_to_next[sc_rows[next_idx]]
    next_cols = sep_to_next[sc_cols[next_idx]]

    next_pattern = sp.csr_matrix(
        (np.arange(next_idx.size, dtype=np.int64), (next_rows, next_cols)),
        shape=(next_nodes.size, next_nodes.size))
    next_pattern.sort_indices()
    # next_idx must follow the CSR entry order of next_pattern
    perm = next_pattern.data
    next_idx = next_idx[perm]
    next_rows_csr = np.repeat(np.arange(next_nodes.size),
                              np.diff(next_pattern.indptr))
    next_cols_csr = next_pattern.indices.astype(np.int64)
    next_pattern.data = np.arange(next_idx.size, dtype=np.int64)

    diag_entry = csr_entry_ids(next_pattern,
                               np.arange(next_nodes.size),
                               np.arange(next_nodes.size))
    assert np.all(diag_entry < next_idx.size), \
        "missing diagonal in next-level pattern"

    # --- next test vector ---------------------------------------------------
    tv_next = np.zeros(next_nodes.size)
    if apply_dropping:
        for gi in range(n_groups):
            g = groups[gi]
            locs = _locate(nodes, g.nodes)
            v = tv_nodes[locs]
            if reflectors[gi] is None:
                val = -v[0]
            else:
                val = np.sign(v[0]) * np.linalg.norm(v)
            tv_next[sep_to_next[vsum_sep_loc[gi]]] = val
    else:
        tv_next = tv_nodes[_locate(nodes, next_nodes)].copy()

    # --- gather-form inverse maps (TPU scatter avoidance) -------------------
    # contributions of per-subdomain separator vectors to the global one
    tgt = np.concatenate(sep_locs_sd) if sep_locs_sd else \
        np.empty(0, dtype=np.int64)
    src = np.concatenate([sd * ns + np.arange(len(sep_locs_sd[sd]))
                          for sd in range(n_sd)]) if n_sd else \
        np.empty(0, dtype=np.int64)
    sep_from_sd = _invert_to_padded(tgt, src, n_sep, n_sd * ns)

    # orthogonal transform: every separator node sits in at most one
    # reflector row at one position
    ot_inv_idx = np.full(n_sep, w_vals.size, dtype=np.int64)
    ot_row_of = np.full(n_sep, w_pos.shape[0], dtype=np.int64)
    wr, wc = np.nonzero(w_pos < n_sep)
    ot_inv_idx[w_pos[wr, wc]] = wr * w_pos.shape[1] + wc
    ot_row_of[w_pos[wr, wc]] = wr

    # non-Vsum blocks: each separator node in at most one block slot
    blk_inv_idx = np.full(n_sep, blk_pos.size if blk_pos.size else 1,
                          dtype=np.int64)
    if blk_pos.size:
        br, bc = np.nonzero(blk_pos < n_sep)
        blk_inv_idx[blk_pos[br, bc]] = br * blk_pos.shape[1] + bc

    # vsum slots
    vsum_slot = np.full(n_sep, vsum_pos.size, dtype=np.int64)
    vsum_slot[vsum_pos] = np.arange(vsum_pos.size)

    # final solution gather: interiors from x1.flat, separators from x2
    node_src = np.full(nodes.size, n_sd * ni + n_sep, dtype=np.int64)
    for sd in range(n_sd):
        node_src[int_locs[sd]] = sd * ni + np.arange(len(int_locs[sd]))
    node_src[sep_pos_in_nodes] = n_sd * ni + np.arange(n_sep)

    # Schur contributions as padded gather
    sc11_gather = _invert_to_padded(sc11_seg, sc11_src, nnz_sc,
                                    n_sd * ns * ns)

    plan = LevelPlan(
        level=level, n_nodes=nodes.size, n_sep=n_sep, nnz=nnz,
        nnz_sc=nnz_sc,
        sep_from_sd=sep_from_sd, ot_inv_idx=ot_inv_idx,
        ot_row_of=ot_row_of, blk_inv_idx=blk_inv_idx,
        vsum_slot=vsum_slot, node_src=node_src, sc11_gather=sc11_gather,
        int_pos=int_pos, int_mask=int_mask,
        sd_sep_pos=sd_sep_pos, sd_sep_mask=sd_sep_mask,
        sep_pos_in_nodes=sep_pos_in_nodes,
        A11_idx=A11_idx, A12_idx=A12_idx, A21_idx=A21_idx, A22_idx=A22_idx,
        Q=Q, w_vals=w_vals, w_pos=w_pos,
        sc22_src=sc22_src, sc11_src=sc11_src, sc11_seg=sc11_seg,
        blk_idx=blk_idx, blk_pos=blk_pos, blk_mask=blk_mask,
        vsum_pos=vsum_pos, next_idx=next_idx,
        apply_ot=apply_dropping,
        next_diag_entry=diag_entry,
        next_rows=next_rows_csr, next_cols=next_cols_csr,
        next_nodes=next_nodes, next_pattern=next_pattern,
    )
    return plan, tv_next


# ---------------------------------------------------------------------------
# Coarse (direct) level
# ---------------------------------------------------------------------------

@dataclass
class CoarsePlan:
    """Dense direct solve of the final reduced matrix
    (reference src/HYMLS_CoarseSolver.cpp: drop RelFullDiag + fix GIDs +
    sparse LU; here: dense scatter + batched-free LU on device)."""

    n: int
    rows: np.ndarray          # (nnz,) local row ids
    cols: np.ndarray          # (nnz,)
    diag_entry: np.ndarray    # (n,) entry id of the diagonal
    fix_rows: np.ndarray      # local ids with Dirichlet fix (may be empty)


def build_coarse_plan(pattern: sp.csr_matrix, nodes: np.ndarray,
                      fix_gids: List[int]) -> CoarsePlan:
    n = nodes.size
    rows = np.repeat(np.arange(n), np.diff(pattern.indptr))
    cols = pattern.indices.astype(np.int64)
    diag_entry = csr_entry_ids(pattern, np.arange(n), np.arange(n))
    fix_local = []
    for gid in fix_gids:
        pos = np.searchsorted(nodes, gid)
        if pos < n and nodes[pos] == gid:
            fix_local.append(pos)
    return CoarsePlan(n=n, rows=rows, cols=cols, diag_entry=diag_entry,
                      fix_rows=np.array(fix_local, dtype=np.int64))
