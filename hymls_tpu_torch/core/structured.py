"""Structured (gather-free) V-cycle apply for Cartesian and skew
partitions.

Torch counterpart of hymls_tpu/core/structured.py.  On a Cartesian
partition of a regular grid the generic apply's index maps are not
arbitrary: subdomains tile the grid, separator groups sit at fixed
in-box offsets and inter-subdomain coupling is nearest-neighbour.  The
host detection below (a copy of the reference's pure-numpy code) finds
that structure in the generic level plans; `StructuredProgram` then
runs the apply as reshapes, permutes, static `torch.roll`s and one-hot
`einsum`s in place of the generic path's gathers:

  * `build_structured_program(precond)` runs once per problem
    structure and returns None (with `precond._structured_reason` set)
    when the generic gather path must be kept;
  * every level vector is a (nK, nJ, nI, channels) tensor over the
    3-axis box grid (nK = 1 for 2-D problems);
  * `repack(factors)` (once per factorization) folds the per-class
    one-hot slot selections into the batched factors;
  * the inter-subdomain contribution exchange (the reference's
    Export-with-Add) is a `torch.roll` over the box grid with static
    per-template neighbour offsets; on periodic grids the roll's
    wraparound is the periodic coupling.

Skew (diamond) levels run in 'perm' mode: the node <-> (box, channel)
map is one static index gather on entry and one on exit, always a
plain gather with a zero sentinel (the reference's sort-key variant,
core/permute.py, is a TPU workaround and is not ported).

One-hot folds must not round data.  The reference pins
`lax.Precision.HIGHEST` on each of them; here the true-f32 pin of
`hymls_tpu_torch/__init__.py` (TF32 off) does the same for every
einsum (tests/test_torch_structured.py checks the repack against an
explicit gather).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..parallel import collectives as C
from ..utils.timings import prof
from .dense import dense_solve as _dense_solve


Off = Tuple[int, int, int]

#: the `prof` span of the V-cycle's level l, made once: `hymls.apply.L<l>`
APPLY_LEVEL_SPANS = tuple(f"hymls.apply.L{lev}" for lev in range(32))


# ---------------------------------------------------------------------------
# detection containers
# ---------------------------------------------------------------------------

@dataclass
class STemplate:
    type: int
    occ: int
    width: int                   # canonical group size
    chs: np.ndarray              # (width,) canonical in-box channel ids
    valid: np.ndarray            # (nK, nJ, nI) instance validity
    slot_valid: np.ndarray       # (nK, nJ, nI, width)
    w: np.ndarray                # (nK, nJ, nI, width) reflector values (0 pad)
    offsets: List[Off] = field(default_factory=list)
    nc_base: List[int] = field(default_factory=list)
    base: int = 0                # offset of this template in the NS axis


@dataclass
class SCombo:
    members: List[int]           # template ids in generic lset order
    m: int                       # canonical block width = sum(W_T - 1)
    blk_map: np.ndarray          # (nK, nJ, nI) -> generic block id (+sentinel)
    valid: np.ndarray            # (nK, nJ, nI)


@dataclass
class SLevel:
    nK: int
    nJ: int
    nI: int
    NCH: int
    NC: int
    ni_pad: int
    ns_pad: int
    blk_factors: Tuple[int, int, int]     # (bz, by, bx): box size in input units
    in_chan: int                          # channels of the input unit
    templates: List[STemplate] = field(default_factory=list)
    combos: List[SCombo] = field(default_factory=list)
    class_of: Optional[np.ndarray] = None   # (nK, nJ, nI) int
    sel: Optional[np.ndarray] = None        # (n_class, NCH, ni_pad)
    pc: Optional[np.ndarray] = None         # (n_class, NC, ns_pad)
    emb: Optional[List[np.ndarray]] = None  # per combo (n_class, m, mb_pad)
    n_class: int = 0
    # perm-mode levels (skew lattices): level input/output is the flat
    # node vector; entry/exit are index maps instead of reshapes
    mode: str = "reshape"
    sd_of_box: Optional[np.ndarray] = None  # (nK,nJ,nI) -> sd (+sentinel)
    entry: Optional[np.ndarray] = None      # (nK,nJ,nI,NCH) -> input pos
    exit: Optional[np.ndarray] = None       # (n_nodes,) -> flat box chan
    up: Optional[np.ndarray] = None         # (nK*nJ*nI*NT,) -> child out
    n_nodes: int = 0
    in_size: int = 0                        # entry sentinel value
    grid_dims: Optional[Tuple[int, int, int, int]] = None
    # (nz, ny, nx, dof) of the true grid when level-0 boxes OVERHANG a
    # non-divisible grid: entry zero-pads, exit slices back


@dataclass
class SCoarse:
    n: int
    src: np.ndarray              # (n,) flat index into (nK*nJ*nI*NT)
    back: np.ndarray             # (nK*nJ*nI*NT,) index into x_coarse (+sent)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _merge_ordered(canon: List[int], seq: List[int]) -> Optional[List[int]]:
    """Order-preserving union of two sequences (both subsequences of an
    unknown master order).  None if the orders conflict."""
    out: List[int] = []
    i = j = 0
    sc = set(canon)
    ss = set(seq)
    while i < len(canon) and j < len(seq):
        a, b = canon[i], seq[j]
        if a == b:
            out.append(a)
            i += 1
            j += 1
        elif a not in ss:
            out.append(a)
            i += 1
        elif b not in sc:
            out.append(b)
            j += 1
        else:
            return None
    out.extend(canon[i:])
    out.extend(seq[j:])
    return out


class _Fallback(Exception):
    pass


def _canon_off(raw: int, n: int, periodic: bool) -> int:
    """Canonical contributor offset along one box axis.  On periodic
    axes offsets are equivalence classes modulo the box-grid size (the
    roll's wraparound realizes them); pick the minimal-magnitude
    representative, deterministically."""
    if not periodic or n == 0:
        return raw
    off = raw % n
    if off > n // 2:
        off -= n
    return off


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def _detect_level(plan, hier, coords, dims, periodic, ni_pad, ns_pad,
                  mb_pad, sd_box=None):
    """Build one SLevel.  coords: (n_nodes_level,) -> (K, J, I, ch)
    arrays (positions in the level node vector).  dims = (nK, nJ, nI,
    NCH); periodic = per-axis wrap flags (pz, py, px).  sd_box: explicit
    (n_sd, 3) subdomain -> box assignment (skew lattices; boxes without
    a subdomain are allowed and masked).  None = dense row-major boxes
    (Cartesian).  Raises _Fallback on any violated assumption."""
    nK, nJ, nI, NCH = dims
    cK, cJ, cI, cCH = coords
    n_sd = hier.num_subdomains
    if sd_box is None:
        if n_sd != nK * nJ * nI:
            raise _Fallback("subdomain count != box grid")
        sd_ids = np.arange(n_sd)
        sd_box = np.stack([sd_ids // (nJ * nI), (sd_ids // nI) % nJ,
                           sd_ids % nI], axis=1)
    else:
        sd_box = np.asarray(sd_box, dtype=np.int64)
        if sd_box.shape != (n_sd, 3):
            raise _Fallback("sd_box shape mismatch")
        flat = (sd_box[:, 0] * nJ + sd_box[:, 1]) * nI + sd_box[:, 2]
        if flat.min() < 0 or flat.max() >= nK * nJ * nI or \
                np.unique(flat).size != n_sd:
            raise _Fallback("sd_box not injective")
    sd_at: Dict[Tuple[int, int, int], int] = {
        tuple(int(v) for v in sd_box[sd]): sd for sd in range(n_sd)}

    def box_of(sd):
        return tuple(int(v) for v in sd_box[sd])

    groups = hier.groups
    n_groups = len(groups)

    # -- group instances ----------------------------------------------------
    g_box = np.empty((n_groups, 3), dtype=np.int64)
    g_chs: List[np.ndarray] = []
    for gi, grp in enumerate(groups):
        pos = grp._pos                     # filled by caller
        K, J, I, ch = cK[pos], cJ[pos], cI[pos], cCH[pos]
        if K.min() != K.max() or J.min() != J.max() or I.min() != I.max():
            raise _Fallback("group spans boxes")
        g_box[gi] = (K[0], J[0], I[0])
        g_chs.append(ch)

    # occurrence rank within owner box per type
    by_box: Dict[Tuple[int, int, int], List[int]] = {}
    for gi in range(n_groups):
        by_box.setdefault(tuple(int(v) for v in g_box[gi]), []).append(gi)
    occ_of = np.zeros(n_groups, dtype=np.int64)
    for box, gis in by_box.items():
        per_type: Dict[int, List[int]] = {}
        for gi in gis:
            per_type.setdefault(groups[gi].type, []).append(gi)
        for t, lst in per_type.items():
            lst.sort(key=lambda gi: int(g_chs[gi][0]))
            for r, gi in enumerate(lst):
                occ_of[gi] = r

    # template clustering; the leading (Vsum) channel is part of the
    # key so every instance of a template has its Vsum carrier at
    # canonical slot 0 (boundary-truncated instances that START at a
    # different node become their own template)
    tmpl_key: Dict[Tuple[int, int, int], int] = {}
    tmpl_groups: List[List[int]] = []
    for gi in range(n_groups):
        key = (groups[gi].type, int(occ_of[gi]), int(g_chs[gi][0]))
        ti = tmpl_key.get(key)
        if ti is None:
            ti = len(tmpl_groups)
            tmpl_key[key] = ti
            tmpl_groups.append([])
        tmpl_groups[ti].append(gi)
    if len(tmpl_groups) > 192:
        raise _Fallback("too many templates")

    # canonical channel lists (order-preserving union of instances)
    sep_sorted = np.unique(hier.all_separator_nodes())
    templates: List[STemplate] = []
    g_tmpl = np.zeros(n_groups, dtype=np.int64)
    for ti, gis in enumerate(tmpl_groups):
        canon: List[int] = []
        for gi in gis:
            canon = _merge_ordered(canon, [int(c) for c in g_chs[gi]])
            if canon is None:
                raise _Fallback("inconsistent group channel order")
        W = len(canon)
        ch_rank = {c: p for p, c in enumerate(canon)}
        valid = np.zeros((nK, nJ, nI), dtype=bool)
        slot_valid = np.zeros((nK, nJ, nI, W), dtype=bool)
        w = np.zeros((nK, nJ, nI, W))
        for gi in gis:
            K, J, I = g_box[gi]
            if int(g_chs[gi][0]) != canon[0]:
                raise _Fallback("instance missing canonical Vsum slot")
            valid[K, J, I] = True
            slots = [ch_rank[int(c)] for c in g_chs[gi]]
            slot_valid[K, J, I, slots] = True
            g_tmpl[gi] = ti
            # reflector values from the plan (ot_row_of/w_vals)
            locs = np.searchsorted(sep_sorted, groups[gi].nodes)
            row = plan.ot_row_of[locs[0]]
            if row < plan.w_pos.shape[0]:
                sz = groups[gi].nodes.size
                w[K, J, I, slots] = plan.w_vals[row, :sz]
        templates.append(STemplate(
            type=groups[gis[0]].type, occ=int(occ_of[gis[0]]), width=W,
            chs=np.array(canon, dtype=np.int64), valid=valid,
            slot_valid=slot_valid, w=w))

    # contributor offsets per template (owner - contributor), ordered;
    # canonicalized modulo the box grid on periodic axes
    ns_grid = (nK, nJ, nI)

    def canon3(raw: Off) -> Off:
        return tuple(_canon_off(raw[a], ns_grid[a], periodic[a])
                     for a in range(3))

    # Role absence needs no explicit masks: the per-class pc/sel folds
    # zero every NC channel a subdomain does not actually contribute,
    # so a boundary instance missing a role reads an exact zero, and a
    # roll that wraps off-grid carries only zeros (the wrapped source
    # box has the role only if ITS owner is on-grid, in which case the
    # modular shift lands it exactly there).  Offsets are therefore
    # just the union over instances; two true roles collapsing onto
    # one canonical offset (tiny periodic grids) also sum correctly
    # through the shared fold row.
    contrib: List[Dict[Off, int]] = [dict() for _ in templates]
    for sd in range(n_sd):
        K, J, I = box_of(sd)
        for gi in hier.sd_groups[sd]:
            ti = g_tmpl[gi]
            off = canon3((int(g_box[gi, 0]) - K,
                          int(g_box[gi, 1]) - J,
                          int(g_box[gi, 2]) - I))
            contrib[ti][off] = contrib[ti].get(off, 0) + 1
    for ti, T in enumerate(templates):
        T.offsets = sorted(contrib[ti].keys())

    # NS / NC layouts
    base = 0
    for T in templates:
        T.base = base
        base += T.width
    nc = 0
    for T in templates:
        T.nc_base = []
        for _ in T.offsets:
            T.nc_base.append(nc)
            nc += T.width
    NC = nc

    # -- per-box class signatures -------------------------------------------
    # interior channels (generic slot order) and the sd separator-slot
    # layout (generic ns order: groups concatenated in sd_groups order)
    int_chs: List[List[int]] = []
    ns_layout: List[List[Tuple[int, int, int]]] = []   # (T, role, pos)
    for sd in range(n_sd):
        K, J, I = box_of(sd)
        pos = hier._int_pos[sd]              # positions in node vector
        if pos.size and not (np.all(cK[pos] == K) and
                             np.all(cJ[pos] == J) and np.all(cI[pos] == I)):
            raise _Fallback("interior outside own box")
        int_chs.append([int(c) for c in cCH[pos]])
        lay: List[Tuple[int, int, int]] = []
        for gi in hier.sd_groups[sd]:
            ti = int(g_tmpl[gi])
            T = templates[ti]
            off = canon3((int(g_box[gi, 0]) - K,
                          int(g_box[gi, 1]) - J,
                          int(g_box[gi, 2]) - I))
            role = T.offsets.index(off)
            ch_rank = {c: p for p, c in enumerate(
                [int(x) for x in T.chs])}
            for c in g_chs[gi]:
                lay.append((ti, role, ch_rank[int(c)]))
        ns_layout.append(lay)

    # block (linked-set) enumeration, mirroring plan.py's block loop
    lset_block: List[int] = []
    bid = 0
    for lset in hier.linked_sets:
        sizes = [groups[gi].nodes.size for gi in lset]
        if any(s > 1 for s in sizes):
            lset_block.append(bid)
            bid += 1
        else:
            lset_block.append(-1)

    # combos keyed by member-template tuple
    combo_key: Dict[Tuple[int, ...], int] = {}
    combos: List[SCombo] = []
    blk_layout: List[Dict[Tuple[int, int, int],
                          List[Tuple[int, int]]]] = []
    for li, lset in enumerate(hier.linked_sets):
        if lset_block[li] < 0:
            continue
        mts = tuple(int(g_tmpl[gi]) for gi in lset)
        K, J, I = (int(g_box[lset[0], 0]), int(g_box[lset[0], 1]),
                   int(g_box[lset[0], 2]))
        for gi in lset:
            if tuple(int(v) for v in g_box[gi]) != (K, J, I):
                raise _Fallback("linked set spans boxes")
        ci = combo_key.get(mts)
        if ci is None:
            m = sum(templates[t].width - 1 for t in mts)
            ci = len(combos)
            combo_key[mts] = ci
            combos.append(SCombo(
                members=list(mts), m=m,
                blk_map=np.full((nK, nJ, nI), -1, dtype=np.int64),
                valid=np.zeros((nK, nJ, nI), dtype=bool)))
            blk_layout.append({})
        C = combos[ci]
        if C.blk_map[K, J, I] >= 0:
            raise _Fallback("duplicate combo instance")
        C.blk_map[K, J, I] = lset_block[li]
        C.valid[K, J, I] = True
        # generic block slot layout: concat of instance [1:] runs
        lay: List[Tuple[int, int]] = []       # (member_rank, canon pos-1)
        for r, gi in enumerate(lset):
            T = templates[int(g_tmpl[gi])]
            ch_rank = {c: p for p, c in enumerate(
                [int(x) for x in T.chs])}
            for c in g_chs[gi][1:]:
                lay.append((r, ch_rank[int(c)] - 1))
        blk_layout[ci][(K, J, I)] = lay

    # A template may appear in different combos at different boxes
    # (boundary linked sets group types differently than interior
    # ones): per BOX each group belongs to exactly one linked set, and
    # a combo's block tensor is the zero sentinel wherever it has no
    # instance, so the per-combo scatter contributions stay disjoint.
    # Within ONE combo a template may not repeat, which the member
    # tuple construction guarantees (a linked set lists distinct
    # groups of one owner, each clustering to a distinct template
    # because occurrence ranks differ).
    for C in combos:
        if len(set(C.members)) != len(C.members):
            raise _Fallback("template repeated within a combo")

    # class signature = everything per-box the folds depend on
    # (boxes without a subdomain — skew lattice corners — get the
    # empty signature: zero folds, zero factors)
    sig_of: Dict[Tuple, int] = {}
    class_of = np.zeros((nK, nJ, nI), dtype=np.int64)
    cls_sigs: List[Tuple] = []
    for K in range(nK):
        for J in range(nJ):
            for I in range(nI):
                sd = sd_at.get((K, J, I))
                blk_sig = tuple(
                    tuple(blk_layout[ci].get((K, J, I), ()))
                    for ci in range(len(combos)))
                if sd is None:
                    sig = ((), (), blk_sig)
                else:
                    sig = (tuple(int_chs[sd]), tuple(ns_layout[sd]),
                           blk_sig)
                c = sig_of.get(sig)
                if c is None:
                    c = len(cls_sigs)
                    sig_of[sig] = c
                    cls_sigs.append(sig)
                class_of[K, J, I] = c
    n_class = len(cls_sigs)
    if n_class > 96:
        raise _Fallback("too many box classes")

    # fold matrices per class
    sel = np.zeros((n_class, NCH, ni_pad))
    pcm = np.zeros((n_class, NC, ns_pad))
    embs = [np.zeros((n_class, C.m, mb_pad)) for C in combos]
    for c, sig in enumerate(cls_sigs):
        ichs, lay, blk_sig = sig
        for m, ch in enumerate(ichs):
            sel[c, ch, m] = 1.0
        for j, (ti, role, p) in enumerate(lay):
            pcm[c, templates[ti].nc_base[role] + p, j] = 1.0
        for ci, bl in enumerate(blk_sig):
            starts = np.cumsum(
                [0] + [templates[t].width - 1
                       for t in combos[ci].members])[:-1]
            for slot, (r, p) in enumerate(bl):
                embs[ci][c, starts[r] + p, slot] = 1.0

    sd_of_box = np.full((nK, nJ, nI), n_sd, dtype=np.int64)
    for sd in range(n_sd):
        sd_of_box[tuple(sd_box[sd])] = sd
    lev = SLevel(nK=nK, nJ=nJ, nI=nI, NCH=NCH, NC=NC, ni_pad=ni_pad,
                 ns_pad=ns_pad, blk_factors=(0, 0, 0), in_chan=0,
                 templates=templates, combos=combos, class_of=class_of,
                 sel=sel, pc=pcm, emb=embs, n_class=n_class,
                 sd_of_box=sd_of_box)
    # map for next level: vsum GID -> (K, J, I, template)
    vmap: Dict[int, Tuple[int, int, int, int]] = {}
    for gi in range(n_groups):
        vmap[int(groups[gi].nodes[0])] = (
            int(g_box[gi, 0]), int(g_box[gi, 1]), int(g_box[gi, 2]),
            int(g_tmpl[gi]))
    return lev, vmap


def build_structured_program(precond, max_elements=None
                             ) -> Optional["StructuredProgram"]:
    """Detect Cartesian structure in a Preconditioner's plans.  Returns
    None (with .reason set on the precond) if the generic path must be
    kept.  `max_elements` (Auto mode) bounds the total folded-factor
    tensor size: the check runs after the cheap structure DETECTION but
    before the expensive constant/one-hot construction — building the
    program first and discarding it costs minutes of host time and
    device transfers on large skew-3D problems."""
    try:
        return _build_impl(precond, max_elements)
    except _Fallback as e:
        precond._structured_reason = str(e)
        return None


def _finalize_program(levels, coarse, dtype, max_elements, device):
    if max_elements is not None:
        est = sum(L.nK * L.nJ * L.nI * L.NCH * L.NCH for L in levels)
        if est > max_elements:
            raise _Fallback(
                f"auto: factor tensors too large ({est:.2g} el)")
    return StructuredProgram(levels, coarse, dtype, device=device)


def _build_skew(precond, parts, max_elements=None):
    """Structured program for the Skew-Cartesian (diamond) partitioner.

    Diamond centers form a SQUARE lattice in the rotated coordinates
    (A, B) = ((x+y)/sx, (x-y)/sx), so all separator/contribution
    machinery of `_detect_level` applies verbatim with (A, B) as the
    box axes (boxes without a diamond — lattice corners — are masked).
    What cannot be a reshape is the node <-> (box, channel) map, so
    every skew level runs in 'perm' mode: one static index gather on
    entry and one on the solution path per level, on geometrically
    shrinking vectors; everything between is the same roll+fold
    program as the Cartesian case.

    Node -> box assignment follows OWNERSHIP (interior nodes -> their
    subdomain, separator nodes -> the group owner's subdomain,
    reference HYMLS_HierarchicalMap group ownership), which absorbs
    the partitioner's boundary reassignment rules; channels enumerate
    the observed (dy, dx, dof) offsets from the owning diamond's
    center."""
    from ..partition.skew import SkewCartesianPartitioner

    g = precond.grid
    if g.perio:
        raise _Fallback("periodic skew not structured")

    levels: List[SLevel] = []
    nodes = np.arange(g.num_nodes, dtype=np.int64)
    vmap_prev = None

    for lev in range(precond.max_level):
        plan = precond.plans[lev]
        hier = precond.hierarchies[lev]
        part = parts[lev]
        sx = part.sx
        sk = SkewCartesianPartitioner(g, part)
        valid = sk.valid_subdomain_ids()
        n_sd = hier.num_subdomains
        if len(valid) != n_sd:
            raise _Fallback("skew subdomain count mismatch")

        # diamond lattice coordinates per subdomain: (A, B) is the
        # 45-degree-rotated in-plane lattice, K the z layer (3D skew
        # stacks the diamond lattice per layer)
        KAB = np.empty((n_sd, 3), dtype=np.int64)
        centers = np.empty((n_sd, 3), dtype=np.int64)
        for k, sd_p in enumerate(valid):
            x, y, z, _ok = sk.position(sd_p)
            if (x + y) % sx or (x - y) % sx or z % sx:
                raise _Fallback("diamond center off-lattice")
            KAB[k] = (z // sx, (x + y) // sx, (x - y) // sx)
            centers[k] = (x, y, z)
        KAB -= KAB.min(axis=0)
        nK = int(KAB[:, 0].max()) + 1
        nJ, nI = int(KAB[:, 1].max()) + 1, int(KAB[:, 2].max()) + 1
        flat = (KAB[:, 0] * nJ + KAB[:, 1]) * nI + KAB[:, 2]
        if np.unique(flat).size != n_sd:
            raise _Fallback("skew lattice collision")
        sd_box = KAB

        # owner assignment: node -> subdomain
        n_nodes = nodes.size
        owner = np.full(n_nodes, -1, dtype=np.int64)
        for sd in range(n_sd):
            pos = np.searchsorted(nodes, hier.interior[sd])
            owner[pos] = sd
        for gi, grp in enumerate(hier.groups):
            pos = np.searchsorted(nodes, grp.nodes)
            owner[pos] = hier.group_owner[gi]
        if (owner < 0).any():
            raise _Fallback("unassigned nodes")

        # channels: rank of (dz, dy, dx, d) among observed offsets
        gids = nodes
        d = gids % g.dof
        cell = gids // g.dof
        x = cell % g.nx
        y = (cell // g.nx) % g.ny
        z = cell // (g.nx * g.ny)
        rel = np.stack([z - centers[owner, 2], y - centers[owner, 1],
                        x - centers[owner, 0], d], axis=1)
        uniq, cCH = np.unique(rel, axis=0, return_inverse=True)
        cCH = cCH.ravel()
        NCH = uniq.shape[0]
        if NCH > 4096:
            raise _Fallback("skew channel space too large")
        cK = KAB[owner, 0]
        cJ = KAB[owner, 1]
        cI = KAB[owner, 2]
        # per-box channel uniqueness (distinct nodes, same box+rel
        # cannot happen: rel is injective per box by construction)

        ni_pad = plan.int_pos.shape[1]
        ns_pad = plan.sd_sep_pos.shape[1]
        mb_pad = plan.blk_idx.shape[1] if plan.blk_idx.size else 1
        for gi, grp in enumerate(hier.groups):
            grp._pos = np.searchsorted(nodes, grp.nodes)
        hier._int_pos = [np.searchsorted(nodes, hier.interior[sd])
                         for sd in range(n_sd)]
        dims = (nK, nJ, nI, NCH)
        slev, vmap = _detect_level(
            plan, hier, (cK, cJ, cI, cCH), dims, (False, False, False),
            ni_pad, ns_pad, mb_pad, sd_box=sd_box)
        slev.mode = "perm"
        slev.n_nodes = n_nodes
        slev.in_chan = NCH

        # entry: (nK, nJ, nI, NCH) -> position in this level's input
        entry = np.full((nK, nJ, nI, NCH), n_nodes, dtype=np.int64)
        entry[cK, cJ, cI, cCH] = np.arange(n_nodes)
        exit_ = ((cK * nJ + cJ) * nI + cI) * NCH + cCH
        slev.exit = exit_

        if lev == 0:
            slev.in_size = n_nodes
            slev.entry = entry
        else:
            # compose with the parent's Vsum layout: the child entry
            # gathers straight from the parent's vs tensor
            parent = levels[-1]
            NTp = len(parent.templates)
            p_size = parent.nK * parent.nJ * parent.nI * NTp
            down = np.empty(n_nodes, dtype=np.int64)
            for p, gid in enumerate(nodes):
                k0, j0, i0, t = vmap_prev[int(gid)]
                down[p] = ((k0 * parent.nJ + j0) * parent.nI + i0) * NTp + t
            down_ext = np.concatenate([down, [p_size]])
            slev.entry = down_ext[np.minimum(entry, n_nodes)]
            slev.in_size = p_size
            # parent's solution-path map: x_next.flat <- child out.flat
            # (sentinel = child out size incl. nK so it reads the
            # appended zero, not a real element, for 3D child grids)
            c_size = nK * nJ * nI * NCH
            up = np.full(p_size, c_size, dtype=np.int64)
            up[down] = exit_
            parent.up = up

        levels.append(slev)
        nodes = plan.next_nodes
        vmap_prev = vmap

    # coarse permutation (same construction as the Cartesian path)
    L = levels[-1]
    NT = len(L.templates)
    n_c = nodes.size
    src = np.empty(n_c, dtype=np.int64)
    back = np.full(L.nK * L.nJ * L.nI * NT, n_c, dtype=np.int64)
    for p, gid in enumerate(nodes):
        k0, j0, i0, t = vmap_prev[int(gid)]
        flat = ((k0 * L.nJ + j0) * L.nI + i0) * NT + t
        src[p] = flat
        back[flat] = p
    coarse = SCoarse(n=n_c, src=src, back=back)
    return _finalize_program(levels, coarse, precond.dtype,
                             max_elements, precond.device)


def _build_impl(precond, max_elements=None):
    from ..grid import X_PERIO, Y_PERIO, Z_PERIO

    g = precond.grid
    if precond.partitioner_type not in ("Cartesian", "Skew Cartesian"):
        raise _Fallback("unknown partitioner")
    # the B-grid Givens pre-transform needs no special handling here:
    # the preconditioner wraps ANY apply as T . apply . T^T (the plans
    # and groups are built on the transformed operator)
    if precond.max_level < 1:
        raise _Fallback("direct-SC mode")
    if precond.variant == "Domain Decomposition":
        raise _Fallback("Domain Decomposition variant")
    if precond.variant == "Do Nothing" and precond.apply_dropping:
        # the plans then hold no block at all, which the block templates
        # below do not expect (the reference's detection fails on them
        # with an IndexError on Cartesian levels)
        raise _Fallback("Do Nothing variant")
    if not precond.apply_dropping:
        raise _Fallback("Apply Dropping == false")
    parts = getattr(precond, "_level_parts", None)
    if parts is None or len(parts) != precond.max_level:
        raise _Fallback("level partition params unavailable")
    if precond.partitioner_type == "Skew Cartesian":
        return _build_skew(precond, parts, max_elements)

    periodic = (bool(g.perio & Z_PERIO), bool(g.perio & Y_PERIO),
                bool(g.perio & X_PERIO))
    dof = g.dof
    levels: List[SLevel] = []
    nodes = np.arange(g.num_nodes, dtype=np.int64)

    def box_dims(part):
        """Box grid (nK, nJ, nI) of one level over the original grid.
        A separator length >= the axis size collapses that axis to one
        box (coarse levels of small grids, e.g. 8^3 with coarsening 4:
        level-1 boxes cover the whole grid)."""
        def axis(n, s):
            if n == 1:
                return 1, 1
            if s >= n:
                return 1, n
            # ceil: a non-divisible axis gets a truncated last box,
            # realized by zero-padding the level-0 grid (the per-class
            # folds mask the phantom channels)
            return -(-n // s), s
        nKb, szK = axis(g.nz, part.sz)
        nJb, syK = axis(g.ny, part.sy)
        nIb, sxK = axis(g.nx, part.sx)
        return (nKb, nJb, nIb), (szK, syK, sxK)

    # level-0 coordinates
    p0 = parts[0]
    (nK, nJ, nI), (szK0, syK0, sxK0) = box_dims(p0)
    NCH = szK0 * syK0 * sxK0 * dof

    def coords_from_grid(gids):
        d = gids % dof
        cell = gids // dof
        x = cell % g.nx
        y = (cell // g.nx) % g.ny
        z = cell // (g.nx * g.ny)
        K = z // szK0
        J = y // syK0
        I = x // sxK0
        ch = (((z % szK0) * syK0 + (y % syK0)) * sxK0
              + (x % sxK0)) * dof + d
        return K, J, I, ch

    coords = coords_from_grid(nodes)
    blk0 = (szK0, syK0, sxK0)
    in_chan0 = dof

    vmap_prev: Optional[Dict[int, Tuple[int, int, int, int]]] = None
    NT_prev = 0
    dims = (nK, nJ, nI, NCH)

    for lev in range(precond.max_level):
        plan = precond.plans[lev]
        hier = precond.hierarchies[lev]
        # positions of group/interior GIDs in the level node vector
        for gi, grp in enumerate(hier.groups):
            grp._pos = np.searchsorted(nodes, grp.nodes)
        hier._int_pos = [np.searchsorted(nodes, hier.interior[sd])
                         for sd in range(hier.num_subdomains)]
        ni_pad = plan.int_pos.shape[1]
        ns_pad = plan.sd_sep_pos.shape[1]
        mb_pad = plan.blk_idx.shape[1] if plan.blk_idx.size else 1
        slev, vmap = _detect_level(plan, hier, coords, dims, periodic,
                                   ni_pad, ns_pad, mb_pad)
        if lev == 0:
            slev.blk_factors = blk0
            slev.in_chan = in_chan0
            if (nK * blk0[0] != max(g.nz, 1) or nJ * blk0[1] != g.ny
                    or nI * blk0[2] != g.nx):
                slev.grid_dims = (max(g.nz, 1), g.ny, g.nx, dof)
        else:
            prev = levels[-1]
            if not (slev.nK and slev.nJ and slev.nI):
                raise _Fallback("empty coarse box grid")
            # ceil ratios: a parent box grid that does not tile evenly
            # is zero-padded on entry (same mechanism as level 0)
            cz = -(-prev.nK // slev.nK)
            cy = -(-prev.nJ // slev.nJ)
            cx = -(-prev.nI // slev.nI)
            slev.blk_factors = (cz, cy, cx)
            slev.in_chan = NT_prev
            if (cz * slev.nK, cy * slev.nJ, cx * slev.nI) != \
                    (prev.nK, prev.nJ, prev.nI):
                slev.grid_dims = (prev.nK, prev.nJ, prev.nI, NT_prev)
        levels.append(slev)

        # next level coordinates
        nodes = plan.next_nodes
        NT = len(slev.templates)
        if lev + 1 < precond.max_level:
            (nKn, nJn, nIn), _ = box_dims(parts[lev + 1])
            cz = -(-slev.nK // nKn)
            cy = -(-slev.nJ // nJn)
            cx = -(-slev.nI // nIn)
            K = np.empty(nodes.size, dtype=np.int64)
            J = np.empty(nodes.size, dtype=np.int64)
            I = np.empty(nodes.size, dtype=np.int64)
            ch = np.empty(nodes.size, dtype=np.int64)
            for p, gid in enumerate(nodes):
                k0, j0, i0, t = vmap[int(gid)]
                K[p] = k0 // cz
                J[p] = j0 // cy
                I[p] = i0 // cx
                ch[p] = (((k0 % cz) * cy + (j0 % cy)) * cx
                         + (i0 % cx)) * NT + t
            coords = (K, J, I, ch)
            dims = (nKn, nJn, nIn, cz * cy * cx * NT)
        NT_prev = NT
        vmap_prev = vmap

    # coarse permutations: coarse nodes are plans[-1].next_nodes sorted
    L = levels[-1]
    NT = len(L.templates)
    n_c = nodes.size
    src = np.empty(n_c, dtype=np.int64)
    back = np.full(L.nK * L.nJ * L.nI * NT, n_c, dtype=np.int64)
    for p, gid in enumerate(nodes):
        k0, j0, i0, t = vmap_prev[int(gid)]
        flat = ((k0 * L.nJ + j0) * L.nI + i0) * NT + t
        src[p] = flat
        back[flat] = p
    coarse = SCoarse(n=n_c, src=src, back=back)
    return _finalize_program(levels, coarse, precond.dtype,
                             max_elements, precond.device)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def _ein(eq, *ops):
    """torch.einsum with the operands promoted to a common dtype, as
    jnp.einsum promotes (f32 factors applied to an f64 vector compute
    in f64)."""
    dts = {o.dtype for o in ops}
    if len(dts) == 1:
        return torch.einsum(eq, *ops)
    dt = functools.reduce(torch.promote_types, dts)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


def _roll(t, o: Off):
    """`t` rolled by the static box offset `o` over its three box axes;
    only the axes with a nonzero shift are rolled (torch.roll runs one
    copy per listed axis, shift 0 included)."""
    axes = [a for a in range(3) if o[a]]
    return torch.roll(t, shifts=[o[a] for a in axes], dims=axes)


def _zext(t):
    """`t` with one zero row appended along dim 0: the sentinel that
    index maps point at for absent entries."""
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


class StructuredProgram:
    """Compiled structured apply.  The device constants (class masks,
    reflectors, one-hot folds, index maps) live in `self.consts` on
    `device`; the static layout (box grids, slot widths, roll offsets)
    stays on the host in `self.levels`, `_offsets` and `_sw`."""

    def __init__(self, levels: List[SLevel], coarse: SCoarse, dtype, *,
                 device):
        self.levels = levels
        self.coarse = coarse
        self.dtype = dtype
        self.device = torch.device(device)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt,
                                   device=self.device)

        def idx(a):
            return dev(np.asarray(a, dtype=np.int64), torch.int64)

        self._const = []
        # static (per level) distinct contributor offsets; the fold
        # matrices indexed alongside them live in consts
        self._offsets: List[List[Off]] = []
        self._sw: List[int] = []
        for ilev, L in enumerate(levels):
            cm = np.zeros((L.n_class, L.nK, L.nJ, L.nI))
            for c in range(L.n_class):
                cm[c] = (L.class_of == c)

            # flat slot space: all templates' slots concatenated, so
            # the per-template loops of the apply become a handful of
            # one-hot matmuls
            NT = len(L.templates)
            sbase = np.cumsum([0] + [T.width for T in L.templates])
            SW = int(sbase[-1])
            E = np.zeros((L.NCH, max(SW, 1)))       # channel <-> slot
            S = np.zeros((max(SW, 1), max(NT, 1)))  # slot -> its template
            V = np.zeros((max(SW, 1), max(NT, 1)))  # Vsum slot indicator
            wf = np.zeros((L.nK, L.nJ, L.nI, max(SW, 1)))
            svf = np.zeros((L.nK, L.nJ, L.nI, max(SW, 1)))
            offsets: Dict[Off, np.ndarray] = {}
            for ti, T in enumerate(L.templates):
                sl = slice(sbase[ti], sbase[ti] + T.width)
                E[T.chs, np.arange(sbase[ti], sbase[ti] + T.width)] = 1.0
                S[sl, ti] = 1.0
                V[sbase[ti], ti] = 1.0
                wf[..., sl] = T.w
                svf[..., sl] = T.slot_valid
                for k, off in enumerate(T.offsets):
                    M = offsets.setdefault(
                        off, np.zeros((max(L.NC, 1), max(SW, 1))))
                    M[np.arange(T.nc_base[k], T.nc_base[k] + T.width),
                      np.arange(sbase[ti], sbase[ti] + T.width)] = 1.0
            off_list = sorted(offsets.keys())
            self._offsets.append(off_list)
            self._sw.append(SW)

            # per-combo non-Vsum slot extraction (slot -> block slot)
            X = []
            for C in L.combos:
                starts = np.cumsum(
                    [0] + [L.templates[t].width - 1 for t in C.members])
                Xc = np.zeros((max(SW, 1), C.m))
                for r, t in enumerate(C.members):
                    Wt = L.templates[t].width
                    Xc[np.arange(sbase[t] + 1, sbase[t] + Wt),
                       np.arange(starts[r], starts[r] + Wt - 1)] = 1.0
                X.append(dev(Xc))

            # perm-mode levels: every static map is a plain index
            # gather whose out-of-range entries read the zero sentinel
            entry = {}
            if L.mode == "perm":
                entry["entry"] = idx(L.entry)
                entry["sdmap"] = idx(L.sd_of_box)
                if ilev == 0:      # the exit map is only applied at lev 0
                    entry["exit"] = idx(L.exit)
                if L.up is not None:
                    entry["up"] = idx(L.up)
            self._const.append({
                "class_mask": dev(cm),
                "sel": dev(L.sel),
                "pc": dev(L.pc),
                "emb": [dev(e) for e in L.emb],
                "blk_map": [idx(C.blk_map) for C in L.combos],
                "E": dev(E),
                "S": dev(S),
                "V": dev(V),
                "wf": dev(wf),
                "svf": dev(svf),
                "offM": [dev(offsets[o]) for o in off_list],
                "X": X,
                **entry,
            })
        self._coarse_const = {"src": idx(coarse.src),
                              "back": idx(coarse.back)}
        self.consts = {"levels": self._const, "coarse": self._coarse_const}

    # -- repack: fold one-hot selections into factors (per factorization) ---
    def repack(self, factors, consts=None):
        """The structured factor tree {"levels": [{A11, A21, G, blk}],
        "coarse"} of a pruned generic factor tree: per box class, the
        generic batched factors conjugated with the class's one-hot
        slot selections (an exact re-layout: no value is rounded)."""
        consts = self.consts if consts is None else consts
        out = {"levels": [], "coarse": factors["coarse"]}
        for lev, L in enumerate(self.levels):
            f = factors["levels"][lev]
            c = consts["levels"][lev]
            nK, nJ, nI = L.nK, L.nJ, L.nI
            if L.mode == "perm":
                # boxes are a sparse lattice over subdomains: route the
                # sd-batched factors through the box->sd map (sentinel
                # row = zeros for empty lattice corners)
                def bx(t):
                    return _zext(t)[c["sdmap"]]
                A11 = bx(f["A11inv"])
                A21 = bx(f["A21"])
                G = bx(f["G"])
            else:
                A11 = f["A11inv"].reshape(nK, nJ, nI, L.ni_pad, L.ni_pad)
                A21 = f["A21"].reshape(nK, nJ, nI, L.ns_pad, L.ni_pad)
                G = f["G"].reshape(nK, nJ, nI, L.ni_pad, L.ns_pad)
            A11s = A11.new_zeros((nK, nJ, nI, L.NCH, L.NCH))
            A21s = A11.new_zeros((nK, nJ, nI, L.NC, L.NCH))
            Gs = A11.new_zeros((nK, nJ, nI, L.NCH, L.NC))
            for ci in range(L.n_class):
                m = c["class_mask"][ci][:, :, :, None, None]
                s = c["sel"][ci]              # (NCH, ni)
                p = c["pc"][ci]               # (NC, ns)
                A11s = A11s + m * _ein("am,kijmn,bn->kijab", s, A11, s)
                A21s = A21s + m * _ein("am,kijmn,bn->kijab", p, A21, s)
                Gs = Gs + m * _ein("am,kijmn,bn->kijab", s, G, p)
            blk = f["blkinv"]
            blk_ext = _zext(blk)
            combos = []
            for C, emb, bmap in zip(L.combos, c["emb"], c["blk_map"]):
                B = blk_ext[torch.where(bmap >= 0, bmap, blk.shape[0])]
                Bs = B.new_zeros((nK, nJ, nI, C.m, C.m))
                for ci in range(L.n_class):
                    m = c["class_mask"][ci][:, :, :, None, None]
                    e = emb[ci]
                    Bs = Bs + m * _ein("am,kijmn,bn->kijab", e, B, e)
                combos.append(Bs)
            out["levels"].append(
                {"A11": A11s, "A21": A21s, "G": Gs, "blk": combos})
        return out

    # -- apply ---------------------------------------------------------------
    def apply(self, sfactors, b, consts=None):
        """x = M^{-1} b for the repacked factor tree `sfactors`; for a
        block b (B, n), one vector per row, the program runs once with a
        leading batch axis (torch.func.vmap, the JAX package's
        `jax.vmap`): each einsum, roll and gather once for the block."""
        if b.dim() == 2:
            return torch.func.vmap(
                lambda v: self.apply(sfactors, v, consts))(b).contiguous()
        consts = self.consts if consts is None else consts
        return self._apply_level(0, sfactors, consts, b, _REPLICATED)

    def _apply_level(self, lev, sfactors, consts, b, sh):
        """Level `lev` of the V-cycle and, through its Vsum solve, every
        level below it, inside the span `hymls.apply.L<lev>`."""
        with prof(APPLY_LEVEL_SPANS[lev], 3):
            return self._level(lev, sfactors, consts, b, sh)

    def _level(self, lev, sfactors, consts, b, sh):
        # all separator work happens in the flat slot space (every
        # template's slots concatenated, SW channels): a handful of
        # one-hot matmul folds and one roll per DISTINCT neighbour
        # offset.  `sh` places the level's box grid: whole on this
        # process (_REPLICATED), or a slab of it (ShardedApply), where
        # `cut` takes the slab of a whole grid, `gather` makes a slab
        # whole again and `roller` rolls a slab
        L = self.levels[lev]
        c = consts["levels"][lev]
        f = sfactors["levels"][lev]
        bz, by, bx = L.blk_factors
        nK, nJ, nI = L.nK, L.nJ, L.nI
        offs = self._offsets[lev]
        SW = self._sw[lev]

        if L.mode == "perm":
            r = _zext(b.reshape(-1))[c["entry"]]
        elif L.grid_dims is not None:
            # boxes overhang a non-divisible parent grid: zero-pad,
            # then the per-class folds treat phantom channels as absent
            dz, dy, dx, dc = L.grid_dims
            gb = torch.nn.functional.pad(
                b.reshape(dz, dy, dx, dc),
                (0, 0, 0, nI * bx - dx, 0, nJ * by - dy, 0, nK * bz - dz))
            r = gb.reshape(nK, bz, nJ, by, nI, bx, dc) \
                  .permute(0, 2, 4, 1, 3, 5, 6).reshape(nK, nJ, nI, L.NCH)
        else:
            r = b.reshape(nK, bz, nJ, by, nI, bx, L.in_chan) \
                 .permute(0, 2, 4, 1, 3, 5, 6).reshape(nK, nJ, nI, L.NCH)
        r = sh.cut(lev, r)
        x1 = _ein("kijab,kijb->kija", f["A11"], r)

        if SW == 0:
            # no separators at this level (degenerate); interior only
            return self._exit_level(lev, sh.gather(lev, x1), c)

        y2c = _ein("kijab,kijb->kija", f["A21"], x1)

        # separator rhs: own values minus neighbour contributions
        acc = _ein("kijc,cs->kijs", r, c["E"])
        roll = sh.roller(lev)
        for o, M in zip(offs, c["offM"]):
            sl = roll(y2c, o) if any(o) else y2c
            acc = acc - _ein("kijn,ns->kijs", sl, M)

        # orthogonal transform (2ww' - I per template; degenerate
        # groups have w=0 -> -I), via segment-indicator folds
        wf = c["wf"]
        d = _ein("kijs,st->kijt", wf * acc, c["S"])
        tt = 2.0 * wf * _ein("kijt,st->kijs", d, c["S"]) - acc

        # non-Vsum block solves (disjoint slot sets per combo)
        y_all = torch.zeros_like(tt)
        for B, X in zip(f["blk"], c["X"]):
            tb = _ein("kijs,sm->kijm", tt, X)
            yb = _ein("kijab,kijb->kija", B, tb)
            y_all = y_all + _ein("kijm,sm->kijs", yb, X)

        # Vsum rhs -> next level / coarse, which start from the whole
        # Vsum grid
        vs = sh.gather(lev, _ein("kijs,st->kijt", tt, c["V"]))
        if lev + 1 < len(self.levels):
            x_next = self._apply_level(lev + 1, sfactors, consts, vs, sh)
            if self.levels[lev + 1].mode == "perm":
                # perm child returns its flat (box, channel) vector;
                # route it back into this level's Vsum layout
                x_next = _zext(x_next)[c["up"]].reshape(vs.shape)
        else:
            rhs = vs.reshape(-1)[consts["coarse"]["src"]]
            with prof("hymls.apply.coarse", 3):
                sol = _dense_solve(sfactors["coarse"], rhs)
            x_next = _zext(sol)[consts["coarse"]["back"]].reshape(vs.shape)
        x_next = sh.cut(lev, x_next)

        # merge Vsum solutions (block solves left those slots zero),
        # inverse transform, mask invalid slots
        y_all = y_all + _ein("kijt,st->kijs", x_next, c["V"])
        d2 = _ein("kijs,st->kijt", wf * y_all, c["S"])
        x2 = (2.0 * wf * _ein("kijt,st->kijs", d2, c["S"]) - y_all) \
            * c["svf"]

        # back-substitution: x2 scattered to contributor layout (NC)
        x2c = None
        roll = sh.roller(lev)
        for o, M in zip(offs, c["offM"]):
            sl = roll(x2, tuple(-v for v in o)) if any(o) else x2
            part = _ein("kijs,ns->kijn", sl, M)
            x2c = part if x2c is None else x2c + part
        if x2c is not None:
            x1 = x1 - _ein("kijab,kijb->kija", f["G"], x2c)

        # merge separators into the channel vector (valid slots are
        # disjoint across templates; invalid slots are zero in x2; the
        # one-hot einsum is the scatter-free embed)
        out = x1 + _ein("kijs,cs->kijc", x2, c["E"])
        return self._exit_level(lev, sh.gather(lev, out), c)

    def sharded_apply_fn(self, mesh, axis_name: Optional[str] = None):
        """The apply with each large box grid split over the ranks of
        `mesh` (ShardedApply): a callable (sfactors, b, consts) -> x, as
        the reference's.  `axis_name` is the reference's GSPMD mesh axis;
        a torch mesh has one axis, so it is ignored."""
        return ShardedApply(self, mesh)

    def _exit_level(self, lev, out, c):
        L = self.levels[lev]
        bz, by, bx = L.blk_factors
        nK, nJ, nI = L.nK, L.nJ, L.nI
        if L.mode == "perm":
            out_flat = out.reshape(-1)
            if lev == 0:
                return out_flat[c["exit"]]
            return out_flat       # the parent routes via its 'up' map
        out = out.reshape(nK, nJ, nI, bz, by, bx, L.in_chan) \
                 .permute(0, 3, 1, 4, 2, 5, 6) \
                 .reshape(nK * bz, nJ * by, nI * bx, L.in_chan)
        if L.grid_dims is not None:
            dz, dy, dx, _dc = L.grid_dims
            out = out[:dz, :dy, :dx]
        if lev == 0:
            return out.reshape(-1)
        return out


# ---------------------------------------------------------------------------
# the apply sharded over the ranks of a mesh
# ---------------------------------------------------------------------------

class _Replicated:
    """The placement of the single-process apply: every box grid whole
    on this process, so there is nothing to cut, gather or exchange."""

    @staticmethod
    def cut(lev, t):
        return t

    @staticmethod
    def gather(lev, t):
        return t

    @staticmethod
    def roller(lev):
        return _roll


_REPLICATED = _Replicated()


def balanced_split(n: int, parts: int) -> List[int]:
    """Sizes of `parts` contiguous slabs of `n` planes that differ by at
    most one, the larger first: 16 on 3 is 6/5/5, 8 on 3 is 3/3/2."""
    q, r = divmod(n, parts)
    return [q + (i < r) for i in range(parts)]


@dataclass(frozen=True)
class Slab:
    """One level's split: the box axis `ax` (0, 1, 2 = K, J, I) cut into
    contiguous slabs of `sizes` planes, rank i holding the i-th."""
    ax: int
    sizes: Tuple[int, ...]

    def start(self, rank: int) -> int:
        return sum(self.sizes[:rank])


def roll_slab(mesh, t, sl: Slab, s: int, tag: Optional[str] = None):
    """This rank's slab of torch.roll(whole, s, dims=sl.ax), from its
    slab `t` of the whole grid: the |s| planes that cross the slab's
    edge come from the ring neighbour by one ppermute (the last rank's
    successor is the first, so the wrap is the periodic roll's)."""
    n, k, ax = mesh.size, abs(s), sl.ax
    if k > min(sl.sizes):
        raise ValueError(f"a roll by {s} crosses a slab of "
                         f"{min(sl.sizes)} planes")
    m = t.shape[ax]
    if s < 0:
        # out[i] = whole[i + k]: the successor's first k planes
        recv = C.ppermute(mesh, t.narrow(ax, 0, k),
                          [(i, (i - 1) % n) for i in range(n)], tag=tag)
        return torch.cat([t, recv], ax).narrow(ax, k, m)
    # out[i] = whole[i - k]: the predecessor's last k planes
    recv = C.ppermute(mesh, t.narrow(ax, m - k, k),
                      [(i, (i + 1) % n) for i in range(n)], tag=tag)
    return torch.cat([recv, t], ax).narrow(ax, 0, m)


class ShardedApply:
    """The structured apply with the box grids split over the ranks of
    `mesh` (torch counterpart of the reference's GSPMD
    `sharded_apply_fn`, hymls_tpu/core/structured.py; the reference's
    Export-with-Add halo traffic, src/HYMLS_Preconditioner.cpp:
    973-1052).  Every rank runs it with the same replicated input and
    gets the same replicated output.

    Which levels shard: a level not in "perm" mode whose largest box axis
    holds at least one box per rank; that axis is cut into contiguous
    slabs of planes (`balanced_split`).  Every other level, and the
    coarse solve, runs whole on every rank, as the reference pins them
    replicated.

    Per apply and sharded level, what crosses ranks:
      * each distinct nonzero shift s along the sharded axis among the
        level's roll offsets moves |s| boundary planes to the ring
        neighbour, once on the way down (the y2c contributions) and
        once in the back-substitution (the x2 solutions): one
        `ppermute` each, tagged "sapply<level>".  The ring wraps from
        the last rank to the first, so the slabs see exactly the
        periodic `torch.roll` of the whole grid; the other axes' shifts
        stay local.  On a 2-D Cartesian grid the offsets' only shift
        along the axis is -1: two ppermutes per level;
      * two `all_gather`s: the Vsum right-hand side before the next
        level (or the coarse solve), and the level's output before its
        exit permute.
    Entry cuts a slab out of the replicated input, and the next level's
    replicated solution, with no communication.

    Factors: the caller computes and repacks the factor tree replicated
    (as the reference's fused program does before GSPMD shards the
    level bodies); each rank cuts its slabs of everything with box axes
    (A11, A21, G, the block combos, and the consts wf and svf) once per
    factor tree: the cut is cached against the identity of the last
    (sfactors, consts) pair, so a compute() or recompute(), which makes
    a new tree, is cut afresh."""

    def __init__(self, prog: StructuredProgram, mesh):
        self.prog = prog
        self.mesh = mesh
        self.slabs: List[Optional[Slab]] = []
        for L in prog.levels:
            dims = (L.nK, L.nJ, L.nI)
            ax = int(np.argmax(dims))
            if L.mode == "perm" or dims[ax] < mesh.size:
                self.slabs.append(None)
            else:
                self.slabs.append(Slab(ax, tuple(balanced_split(
                    dims[ax], mesh.size))))
        self._src = None
        self._local = None

    def __call__(self, sfactors, b, consts=None):
        consts = self.prog.consts if consts is None else consts
        f, c = self.local_trees(sfactors, consts)
        return self.prog._apply_level(0, f, c, b, self)

    def traffic(self, itemsize: int) -> Dict[str, Dict[str, int]]:
        """What one apply on vectors of `itemsize` bytes sends from this
        rank, by the design above, in the form of Mesh.counters:
        {"ppermute": {"calls", "bytes"}, "all_gather": {"calls",
        "bytes"}} (an all_gather sends the longest slab's worth)."""
        out = {p: {"calls": 0, "bytes": 0}
               for p in ("ppermute", "all_gather")}

        def add(prim, words):
            out[prim]["calls"] += 1
            out[prim]["bytes"] += int(words) * itemsize

        for lev, (L, sl) in enumerate(zip(self.prog.levels, self.slabs)):
            if sl is None:
                continue
            plane = L.nK * L.nJ * L.nI // (L.nK, L.nJ, L.nI)[sl.ax]
            width = max(sl.sizes) * plane
            SW = self.prog._sw[lev]
            if SW == 0:
                add("all_gather", width * L.NCH)
                continue
            for s in {o[sl.ax] for o in self.prog._offsets[lev]} - {0}:
                add("ppermute", abs(s) * plane * L.NC)      # y2c, down
                add("ppermute", abs(s) * plane * SW)        # x2, back
            add("all_gather", width * max(len(L.templates), 1))   # vs
            add("all_gather", width * L.NCH)                      # out
        return out

    # -- the slabs of the factors and consts -------------------------------
    def local_trees(self, sfactors, consts):
        """(sfactors, consts) with this rank's slab of every per-box
        tensor of a sharded level, cut once per pair."""
        if self._src is None or self._src[0] is not sfactors or \
                self._src[1] is not consts:
            fl, cl = [], []
            for lev, (f, c) in enumerate(zip(sfactors["levels"],
                                             consts["levels"])):
                if self.slabs[lev] is None:
                    fl.append(f)
                    cl.append(c)
                    continue

                def cut(t, lev=lev):
                    return self.cut(lev, t).contiguous()
                fl.append({"A11": cut(f["A11"]), "A21": cut(f["A21"]),
                           "G": cut(f["G"]),
                           "blk": [cut(B) for B in f["blk"]]})
                cl.append({**c, "wf": cut(c["wf"]), "svf": cut(c["svf"])})
            self._src = (sfactors, consts)
            self._local = ({**sfactors, "levels": fl},
                           {**consts, "levels": cl})
        return self._local

    # -- the placement hooks of StructuredProgram._apply_level -------------
    def cut(self, lev, t):
        """This rank's slab (a view) of a whole box grid `t`."""
        sl = self.slabs[lev]
        if sl is None:
            return t
        r = self.mesh.rank
        return t.narrow(sl.ax, sl.start(r), sl.sizes[r])

    def gather(self, lev, t):
        """The whole box grid from every rank's slab `t`."""
        sl = self.slabs[lev]
        if sl is None:
            return t
        g = C.all_gather(self.mesh, t.movedim(sl.ax, 0), sizes=sl.sizes)
        return g.movedim(0, sl.ax)

    def roller(self, lev):
        """A roll function for one tensor's offsets at level `lev`: the
        shift along the sharded axis is exchanged once per distinct
        shift and kept for the offsets that share it."""
        sl = self.slabs[lev]
        if sl is None:
            return _roll
        done: Dict[int, torch.Tensor] = {}

        def roll(t, o: Off):
            s = o[sl.ax]
            if s:
                if s not in done:
                    done[s] = roll_slab(self.mesh, t, sl, s,
                                        tag=f"sapply{lev}")
                t = done[s]
            rest = tuple(0 if a == sl.ax else v for a, v in enumerate(o))
            return _roll(t, rest) if any(rest) else t
        return roll
