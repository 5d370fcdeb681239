"""Neighbor-halo V-cycle: owner-sharded level vectors with point-to-point
exchanges only on the level path.

Torch counterpart of hymls_tpu/parallel/halo_vcycle.py, one process per
rank.  Every level vector is distributed: each rank owns the interiors
of its contiguous block of subdomains plus the separator nodes whose
first (lowest-id) touching subdomain is local — the ownership rule of
the reference's non-overlapping map (src/HYMLS_HierarchicalMap.cpp:
197-244).  All cross-rank traffic on the level path is `ppermute` of
statically built send lists (parallel/collectives.py):

  * separator partial sums (Export-with-Add): each rank sends the
    per-subdomain contributions that land on a neighbour's separators;
    the owner sums all contributions *in the serial order*, so the
    distributed apply equals the single-process generic apply bit for
    bit on the CPU;
  * Vsum routing: the fine owner of a Vsum sends its value to the
    coarse-level owner of the next-level node (and back on the way up);
  * x2 halo (Import): owners send solved separator values to the
    neighbouring ranks whose subdomains touch them.

The only other collectives are one `all_gather` of the coarsest
right-hand side per apply (the reference gathers the coarse system onto
few ranks, HYMLS_BasePartitioner.cpp:588-683) and, in the bordered
apply, one `psum` of an m-vector per level.

The host plan builders (`compute_ownership`, `build_halo_plans`, the
exchange helpers) are numpy copies of the reference's, so both packages
build equal plans; each rank keeps its own row of every (ndev, ...)
array.  A level with fewer subdomains than ranks times its block leaves
the trailing ranks with sentinel work only (the reference's coarse-level
rank deactivation).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

import torch

from ..core.dense import dense_solve as _dense_solve, _matmul
from . import collectives as C


class UnshardableError(ValueError):
    """The problem's group structure cannot be owner-sharded over this
    many devices (callers should fall back to the replicated apply)."""


# ---------------------------------------------------------------------------
# host-side plan construction
# ---------------------------------------------------------------------------

def _pad_lists(lists, fill):
    """Stack variable-length int lists to (len(lists), max_len)."""
    m = max((len(l) for l in lists), default=0)
    m = max(m, 1)
    out = np.full((len(lists), m), fill, dtype=np.int64)
    for i, l in enumerate(lists):
        out[i, :len(l)] = l
    return out


def _owner_of_seps(plan, own_sd):
    """Owner of each separator node = owner of its lowest touching
    subdomain (the reference's non-overlapping map rule)."""
    n_sep = plan.n_sep
    sd_ids, slot = np.nonzero(plan.sd_sep_mask)
    seps = plan.sd_sep_pos[sd_ids, slot]
    first = np.full(n_sep, own_sd.size, dtype=np.int64)
    np.minimum.at(first, seps, sd_ids)
    if np.any(first >= own_sd.size):
        raise UnshardableError("separator with no touching subdomain")
    return own_sd[first]


def _check_uniform(owner, pos, mask, what):
    """Every entity (reflector row / block) must live on one shard."""
    for i in range(pos.shape[0]):
        seps = pos[i][mask[i]]
        if seps.size and np.unique(owner[seps]).size > 1:
            raise UnshardableError(f"{what} {i} straddles shards")


@dataclass
class _Exchange:
    """One ppermute round per distinct shard offset."""
    offsets: List[int] = field(default_factory=list)
    send_idx: Dict[int, np.ndarray] = field(default_factory=dict)  # (ndev, L)


def _build_exchange(ndev, src_shard, dst_shard, local_idx, order_key):
    """Static send lists for value routing src_shard[i] -> dst_shard[i]
    of value local_idx[i] (index into the sender's local array).
    Receivers locate entries by their canonical rank within each
    (sender, offset) list, ordered by order_key.  Returns
    (_Exchange, pos_of(i) -> (offset, rank))."""
    d_all = dst_shard - src_shard
    offsets = sorted(set(int(d) for d in np.unique(d_all) if d != 0))
    ex = _Exchange(offsets=offsets)
    pos = {}
    for d in offsets:
        lists = [[] for _ in range(ndev)]
        sel = np.nonzero(d_all == d)[0]
        sel = sel[np.argsort(order_key[sel], kind="stable")]
        for i in sel:
            s = int(src_shard[i])
            pos[int(i)] = (d, len(lists[s]))
            lists[s].append(int(local_idx[i]))
        ex.send_idx[d] = _pad_lists(lists, -1)
    return ex, pos


def _finalize_sends(ex: _Exchange, sentinel: int):
    """Replace the -1 padding with the sender-side zero slot."""
    for d in ex.offsets:
        a = ex.send_idx[d]
        ex.send_idx[d] = np.where(a < 0, sentinel, a)
    return ex


def _recv_offsets_table(ex: _Exchange, base: int):
    """Start offset of each offset's recv buffer inside the concat
    [local (base), recv_{d0}, recv_{d1}, ..., zero]."""
    table, off = {}, base
    for d in ex.offsets:
        table[d] = off
        off += ex.send_idx[d].shape[1]
    return table, off          # off == position of the zero sentinel


def compute_ownership(plans, ndev: int):
    """Per-level ownership: (own_sd, own_sep, own_node, loc_of_node)
    lists — shared by the halo V-cycle and the distributed factor
    plans (parallel/dist_compute.py) so both sides agree on the
    owner-sharded layouts."""
    own_sd_l, own_sep_l, own_node_l, loc_of_node_l = [], [], [], []
    for l, plan in enumerate(plans):
        n_sd = plan.int_pos.shape[0]
        # ceil-blocked ownership: when a (coarse) level has fewer
        # subdomains than ndev*B, the trailing shards own nothing and
        # sit out the level — the TPU analog of the reference's
        # coarse-level rank deactivation / communicator restriction
        # (HYMLS_BasePartitioner.cpp:588-683, SetDestinationPID;
        # EpetraExt_RestrictedCrsMatrixWrapper).  Under SPMD the idle
        # shards execute the same program on sentinel zeros; all
        # ppermute routes below are derived from own_sd and therefore
        # converge onto the active sub-mesh automatically.
        B = -(-n_sd // ndev)
        own_sd = np.arange(n_sd) // B
        own_sep = _owner_of_seps(plan, own_sd)
        own_node = np.empty(plan.n_nodes, dtype=np.int64)
        for sd in range(n_sd):
            ints = plan.int_pos[sd][plan.int_mask[sd]]
            own_node[ints] = own_sd[sd]
        own_node[plan.sep_pos_in_nodes] = own_sep
        # local position of each node within its owner's vector
        loc = np.empty(plan.n_nodes, dtype=np.int64)
        counts = np.zeros(ndev, dtype=np.int64)
        order = np.argsort(own_node, kind="stable")
        for n in order:
            loc[n] = counts[own_node[n]]
            counts[own_node[n]] += 1
        own_sd_l.append(own_sd)
        own_sep_l.append(own_sep)
        own_node_l.append(own_node)
        loc_of_node_l.append(loc)
    return own_sd_l, own_sep_l, own_node_l, loc_of_node_l


def build_halo_plans(precond, ndev: int):
    """Host-side construction of all per-shard static index plans.

    Returns (levels, coarse, meta): `levels` is a list of dicts of
    stacked (ndev, ...) numpy arrays (+ static offset lists in meta),
    `coarse` holds the coarse-stage maps, `meta` carries python-level
    statics (offsets per exchange, shapes)."""
    plans = precond.plans
    max_level = precond.max_level
    if max_level < 1:
        raise UnshardableError("halo V-cycle needs Number of Levels >= 1")
    cp = precond.coarse_plan

    levels = []
    meta = []

    # ownership per level (computed top-down; the coarse vector is the
    # last level's vsum set and stays with its fine owners)
    own_sd_l, own_sep_l, own_node_l, loc_of_node_l = \
        compute_ownership(plans, ndev)

    for l, plan in enumerate(plans):
        n_sd = plan.int_pos.shape[0]
        B = -(-n_sd // ndev)
        ni = plan.int_pos.shape[1]
        ns = plan.sd_sep_pos.shape[1]
        own_sd = own_sd_l[l]
        own_sep = own_sep_l[l]
        own_node = own_node_l[l]
        loc = loc_of_node_l[l]
        n_sep = plan.n_sep

        _check_uniform(own_sep, plan.w_pos,
                       plan.w_pos < n_sep, "reflector")
        _check_uniform(own_sep, plan.blk_pos, plan.blk_mask, "block")

        max_onod = int(np.bincount(own_node, minlength=ndev).max())
        sent_in = max_onod                       # zero slot of in_ext

        own_seps = [np.nonzero(own_sep == s)[0] for s in range(ndev)]
        max_osep = max(max(len(a) for a in own_seps), 1)
        o_of_sep = np.full(n_sep, -1, dtype=np.int64)
        for s in range(ndev):
            o_of_sep[own_seps[s]] = np.arange(len(own_seps[s]))

        d = {}
        # --- interiors -------------------------------------------------
        ip = np.full((ndev, B, ni), sent_in, dtype=np.int64)
        for sd in range(n_sd):
            s, j = own_sd[sd], sd % B
            m = plan.int_mask[sd]
            ip[s, j, m] = loc[plan.int_pos[sd][m]]
        d["int_pos_loc"] = ip

        osl = np.full((ndev, max_osep), sent_in, dtype=np.int64)
        for s in range(ndev):
            osl[s, :len(own_seps[s])] = \
                loc[plan.sep_pos_in_nodes[own_seps[s]]]
        d["own_sep_in_loc"] = osl

        # --- separator contribution exchange ---------------------------
        # sep_from_sd rows list flat (sd*ns+slot) sources ascending-sd;
        # keep exactly that order for a bit-identical padded sum.
        sfs = plan.sep_from_sd
        max_c = sfs.shape[1]
        valid = sfs < n_sd * ns
        rows, cols = np.nonzero(valid)
        srcs = sfs[rows, cols]
        src_sd = srcs // ns
        src_sh = own_sd[src_sd]
        dst_sh = own_sep[rows]
        local_flat = srcs - src_sh * (B * ns)
        # canonical receiver order: (sep id, contribution col)
        okey = rows * max_c + cols
        ex_y2, pos_y2 = _build_exchange(ndev, src_sh, dst_sh,
                                        local_flat, okey)
        _finalize_sends(ex_y2, B * ns)
        rtab, zslot = _recv_offsets_table(ex_y2, B * ns)
        sg = np.full((ndev, max_osep, max_c), zslot, dtype=np.int64)
        for i in range(rows.size):
            sep, c = rows[i], cols[i]
            s = dst_sh[i]
            p = o_of_sep[sep]
            if src_sh[i] == s:
                sg[s, p, c] = local_flat[i]
            else:
                dd, rank = pos_y2[int(i)]
                sg[s, p, c] = rtab[dd] + rank
        d["sep_gather"] = sg
        for dd in ex_y2.offsets:
            d[f"y2_send_{dd}"] = ex_y2.send_idx[dd]

        # --- orthogonal transform on owned reflectors -------------------
        n_refl, gmax = plan.w_pos.shape
        refl_owner = np.full(n_refl, -1, dtype=np.int64)
        for i in range(n_refl):
            seps = plan.w_pos[i][plan.w_pos[i] < n_sep]
            if seps.size:
                refl_owner[i] = own_sep[seps[0]]
        wrows = [np.nonzero(refl_owner == s)[0] for s in range(ndev)]
        max_refl = max(max(len(a) for a in wrows), 1)
        wv = np.zeros((ndev, max_refl, gmax))
        wp = np.full((ndev, max_refl, gmax), max_osep, dtype=np.int64)
        r_of = np.full(n_refl, -1, dtype=np.int64)
        for s in range(ndev):
            for k, i in enumerate(wrows[s]):
                r_of[i] = k
                wv[s, k] = plan.w_vals[i]
                m = plan.w_pos[i] < n_sep
                wp[s, k, m] = o_of_sep[plan.w_pos[i][m]]
        d["w_vals_loc"] = wv
        d["w_pos_loc"] = wp
        oi = np.full((ndev, max_osep), max_refl * gmax, dtype=np.int64)
        orw = np.full((ndev, max_osep), max_refl, dtype=np.int64)
        wr, wc = np.nonzero(plan.w_pos < n_sep)
        for i in range(wr.size):
            sep = plan.w_pos[wr[i], wc[i]]
            s, p = own_sep[sep], o_of_sep[sep]
            oi[s, p] = r_of[wr[i]] * gmax + wc[i]
            orw[s, p] = r_of[wr[i]]
        d["ot_inv_idx_loc"] = oi
        d["ot_row_of_loc"] = orw

        # --- non-Vsum blocks -------------------------------------------
        n_blk, mb = plan.blk_pos.shape
        bown = np.full(n_blk, -1, dtype=np.int64)
        for i in range(n_blk):
            seps = plan.blk_pos[i][plan.blk_mask[i]]
            if seps.size:
                bown[i] = own_sep[seps[0]]
        bsets = [np.nonzero(bown == s)[0] for s in range(ndev)]
        max_blk = max(max(len(a) for a in bsets), 1)
        bsel = np.zeros((ndev, max_blk), dtype=np.int64)
        b_of = np.full(n_blk, -1, dtype=np.int64)
        bp = np.full((ndev, max_blk, mb), max_osep, dtype=np.int64)
        for s in range(ndev):
            for k, i in enumerate(bsets[s]):
                bsel[s, k] = i
                b_of[i] = k
                m = plan.blk_mask[i]
                bp[s, k, m] = o_of_sep[plan.blk_pos[i][m]]
        d["blk_pos_loc"] = bp
        bii = np.full((ndev, max_osep), max_blk * mb, dtype=np.int64)
        br, bc = np.nonzero(plan.blk_mask)
        for i in range(br.size):
            sep = plan.blk_pos[br[i], bc[i]]
            s, p = own_sep[sep], o_of_sep[sep]
            bii[s, p] = b_of[br[i]] * mb + bc[i]
        d["blk_inv_idx_loc"] = bii

        # --- vsums ------------------------------------------------------
        vsum_pos = plan.vsum_pos
        n_vs = vsum_pos.size
        vs_owner = own_sep[vsum_pos]
        ovs = [np.nonzero(vs_owner == s)[0] for s in range(ndev)]
        max_ovs = max(max(len(a) for a in ovs), 1)
        j_of_g = np.full(n_vs, -1, dtype=np.int64)
        vpl = np.full((ndev, max_ovs), max_osep, dtype=np.int64)
        for s in range(ndev):
            for k, g in enumerate(ovs[s]):
                j_of_g[g] = k
                vpl[s, k] = o_of_sep[vsum_pos[g]]
        d["vsum_pos_loc"] = vpl
        ovslot = np.full((ndev, max_osep), max_ovs, dtype=np.int64)
        for g in range(n_vs):
            s, p = vs_owner[g], o_of_sep[vsum_pos[g]]
            ovslot[s, p] = j_of_g[g]
        d["own_vsum_slot"] = ovslot

        lm = {"B": B, "ni": ni, "ns": ns, "max_osep": max_osep,
              "max_onod": max_onod, "max_ovs": max_ovs,
              "max_refl": max_refl, "gmax": gmax,
              "max_blk": max_blk, "mb": mb, "max_c": max_c,
              "y2_offsets": ex_y2.offsets, "y2_rtab": rtab,
              "blk_sel": None}
        lm["blk_sel"] = bsel
        # owned-sep slot -> global sep id (sentinel n_sep = zero row);
        # used to stack the bordered bW factor into the owner layout
        bwsel = np.full((ndev, max_osep), n_sep, dtype=np.int64)
        for s in range(ndev):
            bwsel[s, :len(own_seps[s])] = own_seps[s]
        lm["bw_sel"] = bwsel

        # --- next-level routing (down) + reverse (up) -------------------
        if l + 1 < max_level:
            own_nx = own_node_l[l + 1]
            loc_nx = loc_of_node_l[l + 1]
            dst = own_nx[np.arange(n_vs)]
            ex_nx, pos_nx = _build_exchange(
                ndev, vs_owner, dst, j_of_g, np.arange(n_vs))
            _finalize_sends(ex_nx, max_ovs)
            ntab, nz = _recv_offsets_table(ex_nx, max_ovs)
            max_onod_nx = int(np.bincount(own_nx, minlength=ndev).max())
            nig = np.full((ndev, max_onod_nx), nz, dtype=np.int64)
            for g in range(n_vs):
                s2, q = dst[g], loc_nx[g]
                if vs_owner[g] == s2:
                    nig[s2, q] = j_of_g[g]
                else:
                    dd, rank = pos_nx[g]
                    nig[s2, q] = ntab[dd] + rank
            d["next_in_gather"] = nig
            for dd in ex_nx.offsets:
                d[f"nx_send_{dd}"] = ex_nx.send_idx[dd]
            lm["nx_offsets"] = ex_nx.offsets

            # up: coarse owners send solved next-node values back
            max_onod_nxs = max_onod_nx            # sentinel slot
            ex_up, pos_up = _build_exchange(
                ndev, dst, vs_owner, loc_nx[np.arange(n_vs)],
                np.arange(n_vs))
            _finalize_sends(ex_up, max_onod_nxs)
            utab, uz = _recv_offsets_table(ex_up, max_onod_nxs)
            ug = np.full((ndev, max_ovs), uz, dtype=np.int64)
            for g in range(n_vs):
                s, j = vs_owner[g], j_of_g[g]
                if dst[g] == s:
                    ug[s, j] = loc_nx[g]
                else:
                    dd, rank = pos_up[g]
                    ug[s, j] = utab[dd] + rank
            d["up_gather"] = ug
            for dd in ex_up.offsets:
                d[f"up_send_{dd}"] = ex_up.send_idx[dd]
            lm["up_offsets"] = ex_up.offsets
            lm["max_onod_next"] = max_onod_nx

        # --- x2 halo (owners -> touchers) -------------------------------
        sd_ids, slot = np.nonzero(plan.sd_sep_mask)
        seps = plan.sd_sep_pos[sd_ids, slot]
        t_sh = own_sd[sd_ids]                     # toucher shard
        o_sh = own_sep[seps]                      # owner shard
        need = {}                                 # (owner, toucher) -> seps
        for i in range(seps.size):
            if t_sh[i] != o_sh[i]:
                need.setdefault((int(o_sh[i]), int(t_sh[i])),
                                set()).add(int(seps[i]))
        # one entry per (sep, dest shard): canonical order by sep id
        o_list, t_list, p_list, sep_list = [], [], [], []
        for (o, t), ss in sorted(need.items()):
            for sep in sorted(ss):
                o_list.append(o)
                t_list.append(t)
                p_list.append(int(o_of_sep[sep]))
                sep_list.append(sep)
        o_arr = np.asarray(o_list, dtype=np.int64)
        t_arr = np.asarray(t_list, dtype=np.int64)
        p_arr = np.asarray(p_list, dtype=np.int64)
        sep_arr = np.asarray(sep_list, dtype=np.int64)
        ex_x2, pos_x2 = _build_exchange(
            ndev, o_arr, t_arr, p_arr,
            sep_arr) if o_arr.size else (_Exchange(), {})
        _finalize_sends(ex_x2, max_osep)
        xtab, xz = _recv_offsets_table(ex_x2, max_osep)
        # where each (sep, toucher-shard) pair reads from
        read_of = {}
        for i in range(o_arr.size):
            dd, rank = pos_x2[int(i)]
            read_of[(int(sep_arr[i]), int(t_arr[i]))] = xtab[dd] + rank
        ssl = np.full((ndev, B, ns), xz, dtype=np.int64)
        for i in range(seps.size):
            sd, m, sep = sd_ids[i], slot[i], seps[i]
            s, j = own_sd[sd], sd % B
            if own_sep[sep] == s:
                ssl[s, j, m] = o_of_sep[sep]
            else:
                ssl[s, j, m] = read_of[(int(sep), int(s))]
        d["sd_sep_loc"] = ssl
        for dd in ex_x2.offsets:
            d[f"x2_send_{dd}"] = ex_x2.send_idx[dd]
        lm["x2_offsets"] = ex_x2.offsets

        # --- output assembly -------------------------------------------
        nsl = np.full((ndev, max_onod), B * ni + max_osep, dtype=np.int64)
        for n in range(plan.n_nodes):
            s, i = own_node[n], loc[n]
            src = plan.node_src[n]
            if src < n_sd * ni:                   # interior of sd
                sd, k = src // ni, src % ni
                nsl[s, i] = (sd % B) * ni + k
            elif src < n_sd * ni + n_sep:         # separator
                sep = src - n_sd * ni
                nsl[s, i] = B * ni + o_of_sep[sep]
        d["node_src_loc"] = nsl

        levels.append(d)
        meta.append(lm)

    # --- coarse stage ---------------------------------------------------
    last = meta[-1]
    lastp = plans[-1]
    vs_owner = own_sep_l[-1][lastp.vsum_pos]
    n_vs = lastp.vsum_pos.size
    max_ovs = last["max_ovs"]
    stacked_src = np.full(cp.n, ndev * max_ovs, dtype=np.int64)
    own_g = np.full((ndev, max_ovs), cp.n, dtype=np.int64)
    counts = np.zeros(ndev, dtype=np.int64)
    for g in range(n_vs):
        s = vs_owner[g]
        j = counts[s]
        counts[s] += 1
        stacked_src[g] = s * max_ovs + j
        own_g[s, j] = g
    coarse = {"stacked_src": stacked_src, "own_g_idx": own_g}

    # --- level-0 boundary maps ------------------------------------------
    own0, loc0 = own_node_l[0], loc_of_node_l[0]
    n0 = plans[0].n_nodes
    max_onod0 = meta[0]["max_onod"]
    scatter_idx = np.full((ndev, max_onod0), n0, dtype=np.int64)
    gather_idx = np.empty(n0, dtype=np.int64)
    for n in range(n0):
        scatter_idx[own0[n], loc0[n]] = n
        gather_idx[n] = own0[n] * max_onod0 + loc0[n]
    bmaps = {"scatter_idx": scatter_idx, "gather_idx": gather_idx,
             "n_nodes": n0, "max_onod0": max_onod0}

    return levels, coarse, meta, bmaps



# ---------------------------------------------------------------------------
# per-rank apply
# ---------------------------------------------------------------------------

def _cat0(*parts):
    """The parts flattened and concatenated, with the 0.0 sentinel slot
    appended."""
    p0 = parts[0]
    return torch.cat([p.reshape(-1) for p in parts] + [p0.new_zeros(1)])


def _bmm(A, x, pair=False):
    """(s, m, n) @ (s, n) -> (s, m), dtype-promoting (core/preconditioner
    ._bmm).  `pair`: a batch of one is computed as a batch of two (the
    block twice), because the CPU's batched product rounds a batch of
    one (a matrix-vector kernel) otherwise than any larger batch, and
    the single-process apply this must equal runs the whole level as
    one batch."""
    if pair and A.shape[0] == 1:
        return _bmm(torch.cat([A, A]), torch.cat([x, x]))[:1]
    return _matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _ot_local(t, dp):
    """Owner-local Householder transform: the math of
    core.preconditioner._apply_ot on the owned-separator vector."""
    w_vals = dp["w_vals_loc"]
    dots = torch.sum(w_vals * _cat0(t)[dp["w_pos_loc"]], dim=1)
    return 2.0 * _cat0(w_vals)[dp["ot_inv_idx_loc"]] * \
        _cat0(dots)[dp["ot_row_of_loc"]] - t


def _stack_rows(a, rank, B):
    """Rank `rank`'s block of B rows of a (n, ...) batch, zero-padded
    past the end (the reference's (ndev, B, ...) stacking, one row)."""
    part = a[rank * B:(rank + 1) * B]
    pad = B - part.shape[0]
    if pad:
        part = torch.cat([part, part.new_zeros((pad,) + tuple(a.shape[1:]))])
    return part


def rank_slice(arrays: Dict[str, np.ndarray], rank: int, device,
               float_dtype=None, float_keys=()):
    """Row `rank` of every stacked (ndev, ...) plan array, as tensors:
    `float_keys` in `float_dtype`, bool arrays as bool, the rest int64."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)[rank]
        if k in float_keys:
            out[k] = torch.as_tensor(v, dtype=float_dtype, device=device)
        elif v.dtype == bool:
            out[k] = torch.as_tensor(v, device=device)
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.int64), device=device)
    return out


class HaloApply:
    """This rank's part of the distributed V-cycle.  `apply_local(b_l)`
    maps its owner-layout vector (L = max owned level-0 nodes, zero
    padded) to its part of M^{-1} b; `__call__(b)` takes and returns
    global vectors (every rank passes the same b and gets all of x).
    Every rank of the mesh must make the same calls."""

    def __init__(self, precond, mesh):
        self.mesh = mesh
        ndev = mesh.size
        r = mesh.rank
        dev = mesh.device
        levels, coarse, meta, bmaps = build_halo_plans(precond, ndev)
        self.meta = meta
        self._bmaps = bmaps
        self.max_level = precond.max_level
        self.dtype = precond.dtype
        self.dplans = [rank_slice(d, r, dev, precond.dtype, ("w_vals_loc",))
                       for d in levels]
        self.dplans[-1]["own_g_idx"] = torch.as_tensor(
            coarse["own_g_idx"][r], device=dev)
        self._coarse_src = torch.as_tensor(coarse["stacked_src"], device=dev)
        self._bsel = [torch.as_tensor(m["blk_sel"][r], device=dev)
                      for m in meta]
        self._bwsel = [torch.as_tensor(m["bw_sel"][r], device=dev)
                       for m in meta]
        self._scatter = torch.as_tensor(bmaps["scatter_idx"][r], device=dev)
        self._gather = torch.as_tensor(bmaps["gather_idx"], device=dev)
        # levels whose rank-local batch is one block while the whole
        # level has more (see _bmm)
        self._pair = [m["B"] == 1 and p.int_pos.shape[0] > 1
                      for m, p in zip(meta, precond.plans)]
        self._pair_blk = [m["max_blk"] == 1 and p.blk_pos.shape[0] > 1
                          for m, p in zip(meta, precond.plans)]
        self.factors = self.stack_factors(precond.factors.pruned)

    # -- exchanges -----------------------------------------------------------
    def _exchange(self, vals_ext, dp, prefix, offsets, lev):
        """One ppermute per static offset; the received buffers in
        offset order."""
        return [C.shift(self.mesh, vals_ext[dp[f"{prefix}_send_{d}"]], d,
                        tag=f"L{lev}:{prefix}") for d in offsets]

    # -- the levels -----------------------------------------------------------
    def _down(self, lev, b_loc, factors):
        """Interior elimination, separator exchange, transform and block
        solve of one level: (x1, t with its zero slot, y_blk)."""
        lm, dp = self.meta[lev], self.dplans[lev]
        fac = factors["levels"][lev]
        in_ext = _cat0(b_loc)
        pair = self._pair[lev]
        x1 = _bmm(fac["A11inv"], in_ext[dp["int_pos_loc"]], pair)
        y2c = _bmm(fac["A21"], x1, pair)
        recvs = self._exchange(_cat0(y2c), dp, "y2", lm["y2_offsets"], lev)
        y2 = torch.sum(_cat0(y2c, *recvs)[dp["sep_gather"]], dim=1)
        t = _ot_local(in_ext[dp["own_sep_in_loc"]] - y2, dp)
        t_ext = _cat0(t)
        yb = _bmm(fac["blkinv"], t_ext[dp["blk_pos_loc"]],
                  self._pair_blk[lev])
        y_blk = _cat0(yb)[dp["blk_inv_idx_loc"]]
        return x1, t_ext, y_blk

    def _coarse_rhs(self, t_vs):
        allv = C.all_gather(self.mesh, t_vs)
        return _cat0(allv)[self._coarse_src]

    def _route_down(self, lev, t_vs):
        lm, dp = self.meta[lev], self.dplans[lev]
        tve = _cat0(t_vs)
        nrecv = self._exchange(tve, dp, "nx", lm["nx_offsets"], lev)
        return _cat0(t_vs, *nrecv)[dp["next_in_gather"]]

    def _route_up(self, lev, x_next):
        lm, dp = self.meta[lev], self.dplans[lev]
        urecv = self._exchange(_cat0(x_next), dp, "up", lm["up_offsets"], lev)
        return _cat0(x_next, *urecv)[dp["up_gather"]]

    def _up(self, lev, x1, y_vs, y_blk, factors, S=None):
        """Vsum merge, inverse transform, x2 halo and back substitution
        of one level."""
        lm, dp = self.meta[lev], self.dplans[lev]
        fac = factors["levels"][lev]
        y = torch.where(dp["own_vsum_slot"] < lm["max_ovs"],
                        _cat0(y_vs)[dp["own_vsum_slot"]], y_blk)
        x2 = _ot_local(y, dp)
        xrecv = self._exchange(_cat0(x2), dp, "x2", lm["x2_offsets"], lev)
        x2sd = _cat0(x2, *xrecv)[dp["sd_sep_loc"]]
        x1 = x1 - _bmm(fac["G"], x2sd, self._pair[lev])
        if S is not None:
            x1 = x1 - _matmul(fac["border"]["Q1"], S)
        return _cat0(x1, x2)[dp["node_src_loc"]]

    def level_fn(self, lev, b_loc, factors):
        x1, t_ext, y_blk = self._down(lev, b_loc, factors)
        t_vs = t_ext[self.dplans[lev]["vsum_pos_loc"]]
        if lev + 1 == self.max_level:
            xc = _dense_solve(factors["coarse"], self._coarse_rhs(t_vs))
            y_vs = _cat0(xc)[self.dplans[lev]["own_g_idx"]]
        else:
            x_next = self.level_fn(lev + 1, self._route_down(lev, t_vs),
                                   factors)
            y_vs = self._route_up(lev, x_next)
        return self._up(lev, x1, y_vs, y_blk, factors)

    def level_fn_b(self, lev, b_loc, T, factors):
        """Bordered level (reference bordered ApplyInverse,
        HYMLS_SchurPreconditioner.cpp:1517-1619): the border tail T (m,)
        is replicated; its per-level reductions T - W1'x1 - bW'y are
        rank-partial sums combined in one psum of an m-vector per
        level.  Returns (x_loc, S)."""
        x1, t_ext, y_blk = self._down(lev, b_loc, factors)
        bb = factors["levels"][lev]["border"]
        W1 = bb["W1"]
        part = _matmul(W1.reshape(-1, W1.shape[-1]).T, x1.reshape(-1)) + \
            _matmul(bb["bW"].T, y_blk)
        Tc = T - C.psum(self.mesh, part)
        t_vs = t_ext[self.dplans[lev]["vsum_pos_loc"]]
        if lev + 1 == self.max_level:
            rhs = self._coarse_rhs(t_vs)
            n_c = rhs.shape[0]
            sol = _dense_solve(factors["coarse"], torch.cat([rhs, Tc]))
            xc, S = sol[:n_c], sol[n_c:]
            y_vs = _cat0(xc)[self.dplans[lev]["own_g_idx"]]
        else:
            x_next, S = self.level_fn_b(
                lev + 1, self._route_down(lev, t_vs), Tc, factors)
            y_vs = self._route_up(lev, x_next)
        return self._up(lev, x1, y_vs, y_blk, factors, S), S

    # -- factors --------------------------------------------------------------
    def stack_factors(self, factors):
        """This rank's part of a pruned generic factor tree in the halo
        layout: its block of B subdomains per level (zero-padded where a
        coarse level deactivates trailing ranks: padded subdomains then
        compute exact zeros) and its owned non-Vsum blocks."""
        r = self.mesh.rank
        out = {"levels": [], "coarse": factors["coarse"]}
        for l, fac in enumerate(factors["levels"]):
            B = self.meta[l]["B"]
            blkinv = fac["blkinv"]
            if blkinv.shape[0] == 0:
                # a level with no non-Vsum blocks (3-D and skew coarse
                # levels where every separator is a Vsum): the apply
                # reads only sentinel slots, so zero blocks suffice
                blkinv = blkinv.new_zeros(tuple(self._bsel[l].shape) +
                                          tuple(blkinv.shape[1:]))
            else:
                blkinv = blkinv[self._bsel[l]]
            lev = {"A11inv": _stack_rows(fac["A11inv"], r, B),
                   "G": _stack_rows(fac["G"], r, B),
                   "A21": _stack_rows(fac["A21"], r, B),
                   "blkinv": blkinv}
            if "border" in fac:
                # Q1/W1 per subdomain like A11inv; bW over the owned
                # separators (zero row at the sentinel slot)
                bb = fac["border"]
                bW = bb["bW"]
                bW_ext = torch.cat([bW, bW.new_zeros((1, bW.shape[1]))])
                lev["border"] = {"Q1": _stack_rows(bb["Q1"], r, B),
                                 "W1": _stack_rows(bb["W1"], r, B),
                                 "bW": bW_ext[self._bwsel[l]]}
            out["levels"].append(lev)
        return out

    @property
    def bordered(self) -> bool:
        return "border" in self.factors["levels"][0]

    # -- layouts and entry points ---------------------------------------------
    def to_local(self, b):
        """Global vector -> this rank's owner-layout vector (L,)."""
        b = torch.as_tensor(b, device=self.mesh.device)
        return _cat0(b)[self._scatter]

    def to_global(self, x_loc):
        """Owner-layout vectors of all ranks -> the global vector (one
        all_gather)."""
        return C.all_gather(self.mesh, x_loc)[self._gather]

    def apply_local(self, b_loc, factors=None):
        return self.level_fn(0, b_loc, self.factors if factors is None
                             else factors)

    def apply_local_bordered(self, b_loc, T, factors=None):
        return self.level_fn_b(0, b_loc, T, self.factors if factors is None
                               else factors)

    def __call__(self, b):
        return self.to_global(self.apply_local(self.to_local(b)))

    def apply_bordered(self, b, t):
        """Bordered apply [x; s] = M^{-1} [b; t] through the halo path
        (the factors must carry a border).  Returns (x_global, s)."""
        if not self.bordered:
            raise ValueError("preconditioner factors carry no border")
        t = torch.as_tensor(t, dtype=self.dtype, device=self.mesh.device)
        x, S = self.apply_local_bordered(self.to_local(b), t)
        return self.to_global(x), S


def make_halo_apply(precond, mesh) -> HaloApply:
    """Build this rank's part of the neighbor-halo V-cycle of `precond`
    over `mesh`.  Raises UnshardableError when the group structure
    cannot be owner-sharded (callers take the replicated apply)."""
    return HaloApply(precond, mesh)
