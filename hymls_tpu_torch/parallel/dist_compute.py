"""Distributed factorization: per-rank block extraction, point-to-point
Schur-complement assembly, owner-local dropping.

Torch counterpart of hymls_tpu/parallel/dist_compute.py.  The
replicated `Preconditioner.compute()` assembles each level's Schur
values from all subdomains.  The reference HYMLS's setup is distributed:
MatrixBlock extracts per-rank blocks from locally owned rows
(src/HYMLS_MatrixBlock.cpp:74-134) and the Schur assembly exchanges only
off-processor sums (src/HYMLS_SchurPreconditioner.cpp:698-875).  Here,
on the ownership and exchange machinery of halo_vcycle:

  * every rank owns a contiguous block of subdomains (the halo apply's
    ceil-block rule) and extracts and factors only its own A11/A12/A21/
    A22 blocks: at level 0 from the (small, replicated) CSR values, at
    deeper levels from the owner-sharded previous-level values routed
    point to point;
  * the per-subdomain Schur contributions go by ppermute to the entry's
    owner (the owner of its row separator), which sums them in the
    serial order;
  * the RelDropDiag drop runs at the owner; the column-diagonal values
    it needs arrive by one small ppermute round;
  * the factors come out in the halo-apply layout, so the distributed
    Krylov solve takes them as they are;
  * only the coarsest system is all-gathered (the reference's
    restricted-communicator coarse solve).

`build_factor_plans` is a numpy copy of the reference's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

import torch

from ..core.dense import inv_newton as _inv, inv_chain as _inv_chain
from ..core.plan import SMALL_ENTRY
from ..core.preconditioner import _coarse_factor, _cast_tree
from .halo_vcycle import (UnshardableError, _Exchange, _build_exchange,
                          _finalize_sends, _recv_offsets_table, _cat0,
                          compute_ownership, rank_slice)
from . import collectives as C


def _stack_idx(a, ndev, B, sentinel):
    """(n_sd, ...) -> (ndev, B, ...) padded with `sentinel`."""
    pad = ndev * B - a.shape[0]
    if pad:
        fill = np.full((pad,) + a.shape[1:], sentinel, dtype=a.dtype)
        a = np.concatenate([a, fill])
    return a.reshape((ndev, B) + a.shape[1:])


def _stack_val(a, ndev, B):
    pad = ndev * B - a.shape[0]
    if pad:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return a.reshape((ndev, B) + a.shape[1:])


def build_factor_plans(precond, ndev: int):
    """Static per-shard plans for the distributed factorization.

    Returns (fplans, coarse, meta): `fplans[l]` is a dict of stacked
    (ndev, ...) numpy arrays, `meta[l]` carries shapes and ppermute
    offset lists, `coarse` the final gather map."""
    plans = precond.plans
    max_level = precond.max_level
    if max_level < 1:
        raise UnshardableError("distributed factor needs levels >= 1")
    cp = precond.coarse_plan
    own_sd_l, own_sep_l, _own_node_l, _loc_l = \
        compute_ownership(plans, ndev)

    fplans: List[Dict[str, np.ndarray]] = []
    meta: List[dict] = []
    # per-level next-entry ownership, shared between producer (level l)
    # and consumer (level l+1): o_of_next[j], pos_of_next[j]
    o_next_prev = None
    pos_next_prev = None
    max_oj_prev = None
    ex_cv_prev_pos = None        # (entry, consumer) -> recv position

    for l, plan in enumerate(plans):
        n_sd, ni = plan.int_pos.shape
        ns = plan.sd_sep_pos.shape[1]
        B = -(-n_sd // ndev)
        own_sd = own_sd_l[l]
        own_sep = own_sep_l[l]
        nnz = plan.nnz
        d: Dict[str, np.ndarray] = {}
        lm: dict = {"B": B, "ni": ni, "ns": ns}

        # --- block index stacking ---------------------------------------
        if l == 0:
            # level-0 values replicated: keep global entry ids
            # (sentinel nnz -> zero slot of cat0(vals))
            for f in ("A11_idx", "A12_idx", "A21_idx", "A22_idx"):
                d[f] = _stack_idx(getattr(plan, f), ndev, B, nnz)
        else:
            # deeper levels: entries arrive owner-sharded from level
            # l-1 (nxt_loc) plus the consumer-exchange recv buffers;
            # remap global entry ids into that concat layout via a
            # per-shard lookup table (vectorized)
            zslot = ex_cv_prev_pos["zslot"]
            read_of = ex_cv_prev_pos["read_of"]
            o_prev, pos_prev = o_next_prev, pos_next_prev
            ne_prev = o_prev.size
            lut = np.full((ndev, ne_prev + 1), zslot, dtype=np.int64)
            for s in range(ndev):
                mine = o_prev == s
                lut[s, :-1][mine] = pos_prev[mine]
            for (e, t), p in read_of.items():
                lut[t, e] = p

            def _remap(idx):
                st = _stack_idx(idx, ndev, B, ne_prev)
                st = np.minimum(st, ne_prev)
                out = np.empty(st.shape, dtype=np.int64)
                for s in range(ndev):
                    out[s] = lut[s][st[s]]
                return out

            for f in ("A11_idx", "A12_idx", "A21_idx", "A22_idx"):
                d[f] = _remap(getattr(plan, f))

        d["int_mask"] = _stack_idx(plan.int_mask, ndev, B, False)
        d["Q"] = _stack_val(plan.Q, ndev, B)
        # valid (non-pad) subdomain slots: factors of pad slots are
        # zeroed to match the halo stack_factors layout exactly
        d["sd_valid"] = _stack_idx(np.ones(n_sd, dtype=bool), ndev, B,
                                   False)
        lm["apply_ot"] = bool(plan.apply_ot)

        # --- SC assembly exchange ----------------------------------------
        # entry owner = owner of its row separator (from the T22 source)
        nnz_sc = plan.nnz_sc
        src22 = plan.sc22_src
        sd22 = src22 // (ns * ns)
        i22 = (src22 // ns) % ns
        row_sep = plan.sd_sep_pos[sd22, i22]
        o_e = own_sep[row_sep]
        own_e = [np.nonzero(o_e == s)[0] for s in range(ndev)]
        max_oe = max(max(len(a) for a in own_e), 1)
        pos_e = np.full(nnz_sc, -1, dtype=np.int64)
        for s in range(ndev):
            pos_e[own_e[s]] = np.arange(len(own_e[s]))

        # combined sender-local flat space [T22 | T11 | zero]
        tsz = B * ns * ns
        g11 = plan.sc11_gather
        max_c11 = g11.shape[1]
        # contributions: slot 0 = T22 source, slots 1.. = T11 sources
        ents, slots, srcsh, dstsh, lidx = [], [], [], [], []
        for e in range(nnz_sc):
            s22 = src22[e]
            sd = s22 // (ns * ns)
            ents.append(e); slots.append(0)
            srcsh.append(own_sd[sd]); dstsh.append(o_e[e])
            lidx.append((sd % B) * ns * ns + s22 % (ns * ns))
            for c in range(max_c11):
                s11 = g11[e, c]
                if s11 >= n_sd * ns * ns:
                    continue
                sd1 = s11 // (ns * ns)
                ents.append(e); slots.append(1 + c)
                srcsh.append(own_sd[sd1]); dstsh.append(o_e[e])
                lidx.append(tsz + (sd1 % B) * ns * ns + s11 % (ns * ns))
        ents = np.asarray(ents, dtype=np.int64)
        slots = np.asarray(slots, dtype=np.int64)
        srcsh = np.asarray(srcsh, dtype=np.int64)
        dstsh = np.asarray(dstsh, dtype=np.int64)
        lidx = np.asarray(lidx, dtype=np.int64)
        okey = ents * (max_c11 + 1) + slots
        ex_sc, pos_sc = _build_exchange(ndev, srcsh, dstsh, lidx, okey)
        _finalize_sends(ex_sc, 2 * tsz)
        rtab_sc, zslot_sc = _recv_offsets_table(ex_sc, 2 * tsz)
        scg = np.full((ndev, max_oe, max_c11 + 1), zslot_sc,
                      dtype=np.int64)
        for i in range(ents.size):
            e, c = ents[i], slots[i]
            s = dstsh[i]
            p = pos_e[e]
            if srcsh[i] == s:
                scg[s, p, c] = lidx[i]
            else:
                dd, rank = pos_sc[int(i)]
                scg[s, p, c] = rtab_sc[dd] + rank
        d["sc_gather"] = scg
        for dd in ex_sc.offsets:
            d[f"sc_send_{dd}"] = ex_sc.send_idx[dd]
        lm["sc_offsets"] = ex_sc.offsets
        lm["max_oe"] = max_oe
        lm["max_c11"] = max_c11

        # --- non-Vsum blocks (local at the owner) -------------------------
        n_blk, mb = plan.blk_pos.shape
        bown = np.full(n_blk, -1, dtype=np.int64)
        for i in range(n_blk):
            seps = plan.blk_pos[i][plan.blk_mask[i]]
            if seps.size:
                bown[i] = own_sep[seps[0]]
        bsets = [np.nonzero(bown == s)[0] for s in range(ndev)]
        max_blk = max(max(len(a) for a in bsets), 1)
        bidx = np.full((ndev, max_blk, mb, mb), max_oe, dtype=np.int64)
        bmask = np.zeros((ndev, max_blk, mb), dtype=bool)
        for s in range(ndev):
            for k, i in enumerate(bsets[s]):
                gi = plan.blk_idx[i]          # (mb, mb) into sc_vals_ext
                loc = np.where(gi < nnz_sc, pos_e[np.minimum(gi,
                               nnz_sc - 1)], max_oe)
                # entries of an owned block are owned entries: their
                # local position is valid wherever gi is a real entry
                bidx[s, k] = np.where(gi < nnz_sc, loc, max_oe)
                bmask[s, k] = plan.blk_mask[i]
        d["blk_idx_loc"] = bidx
        d["blk_mask"] = bmask
        lm["max_blk"] = max_blk
        lm["mb"] = mb

        # --- next-level values: owner-local drop --------------------------
        nnz_next = plan.next_idx.size
        o_j = o_e[plan.next_idx]
        own_j = [np.nonzero(o_j == s)[0] for s in range(ndev)]
        max_oj = max(max(len(a) for a in own_j), 1)
        pos_j = np.full(nnz_next, -1, dtype=np.int64)
        nxp = np.full((ndev, max_oj), max_oe, dtype=np.int64)
        for s in range(ndev):
            for k, j in enumerate(own_j[s]):
                pos_j[j] = k
                nxp[s, k] = pos_e[plan.next_idx[j]]
        d["nx_pos"] = nxp

        # diag positions: row diag local, col diag via exchange
        diag_of = plan.next_diag_entry      # (n_vsum,) -> next entry id
        drp = np.full((ndev, max_oj), max_oj, dtype=np.int64)
        isd = np.zeros((ndev, max_oj), dtype=bool)
        # (col, consumer) pairs needing a remote diag value
        need = {}
        for j in range(nnz_next):
            s = o_j[j]
            r, c = plan.next_rows[j], plan.next_cols[j]
            drp[s, pos_j[j]] = pos_j[diag_of[r]]
            isd[s, pos_j[j]] = (r == c)
            dj = diag_of[c]
            if o_j[dj] != s:
                need.setdefault((int(dj), int(s)), None)
        pairs = sorted(need.keys())
        if pairs:
            p_e = np.asarray([p[0] for p in pairs], dtype=np.int64)
            p_t = np.asarray([p[1] for p in pairs], dtype=np.int64)
            ex_dg, pos_dg = _build_exchange(ndev, o_j[p_e], p_t,
                                            pos_j[p_e], p_e)
        else:
            p_e = p_t = np.zeros(0, dtype=np.int64)
            ex_dg, pos_dg = _Exchange(), {}
        _finalize_sends(ex_dg, max_oj)
        rtab_dg, zslot_dg = _recv_offsets_table(ex_dg, max_oj)
        read_dg = {}
        for i in range(p_e.size):
            dd, rank = pos_dg[int(i)]
            read_dg[(int(p_e[i]), int(p_t[i]))] = rtab_dg[dd] + rank
        dcp = np.full((ndev, max_oj), zslot_dg, dtype=np.int64)
        for j in range(nnz_next):
            s = o_j[j]
            dj = diag_of[plan.next_cols[j]]
            if o_j[dj] == s:
                dcp[s, pos_j[j]] = pos_j[dj]
            else:
                dcp[s, pos_j[j]] = read_dg[(int(dj), int(s))]
        d["dr_pos"] = drp
        d["dc_pos"] = dcp
        d["nx_isdiag"] = isd
        for dd in ex_dg.offsets:
            d[f"dg_send_{dd}"] = ex_dg.send_idx[dd]
        lm["dg_offsets"] = ex_dg.offsets
        lm["max_oj"] = max_oj

        # --- consumer exchange for the NEXT level -------------------------
        if l + 1 < max_level:
            nxt_plan = plans[l + 1]
            n_sd_n = nxt_plan.int_pos.shape[0]
            B_n = -(-n_sd_n // ndev)
            own_sd_n = own_sd_l[l + 1]
            need_cv = {}
            for f in ("A11_idx", "A12_idx", "A21_idx", "A22_idx"):
                idx = getattr(nxt_plan, f)
                for sd in range(n_sd_n):
                    t = own_sd_n[sd]
                    es = idx[sd].reshape(-1)
                    for e in np.unique(es):
                        if e >= nnz_next:
                            continue
                        if o_j[e] != t:
                            need_cv.setdefault((int(e), int(t)), None)
            cps = sorted(need_cv.keys())
            if cps:
                c_e = np.asarray([p[0] for p in cps], dtype=np.int64)
                c_t = np.asarray([p[1] for p in cps], dtype=np.int64)
                ex_cv, pos_cv = _build_exchange(ndev, o_j[c_e], c_t,
                                                pos_j[c_e], c_e)
            else:
                c_e = c_t = np.zeros(0, dtype=np.int64)
                ex_cv, pos_cv = _Exchange(), {}
            _finalize_sends(ex_cv, max_oj)
            rtab_cv, zslot_cv = _recv_offsets_table(ex_cv, max_oj)
            read_cv = {}
            for i in range(c_e.size):
                dd, rank = pos_cv[int(i)]
                read_cv[(int(c_e[i]), int(c_t[i]))] = rtab_cv[dd] + rank
            for dd in ex_cv.offsets:
                d[f"cv_send_{dd}"] = ex_cv.send_idx[dd]
            lm["cv_offsets"] = ex_cv.offsets
            ex_cv_prev_pos = {"rtab": rtab_cv, "zslot": zslot_cv,
                              "read_of": read_cv}
        o_next_prev, pos_next_prev, max_oj_prev = o_j, pos_j, max_oj

        fplans.append(d)
        meta.append(lm)

    # --- coarse gather ----------------------------------------------------
    # all_gather the last level's owner-sharded next values; reorder to
    # global entry order for the (replicated) dense coarse factor
    vsrc = o_next_prev * max_oj_prev + pos_next_prev
    coarse = {"vsrc": vsrc}
    return fplans, coarse, meta




class DistributedCompute:
    """This rank's part of the distributed factorization: `compute(vals)`
    maps the (replicated) CSR values to the rank's factors in the halo
    layout.  Every rank of the mesh must call it with the same values.

    Factor upcast (f64 assembly, f32 store: the mixed-precision chain
    of core/preconditioner._compute_level) is the reference's: the
    values chain A11inv -> G -> T11 -> Schur -> next level runs in the
    factor dtype, the non-Vsum blocks and the coarse system are inverted
    in the store dtype, and the factors come back in the apply dtype."""

    def __init__(self, precond, mesh):
        self.mesh = mesh
        ndev, r, dev = mesh.size, mesh.rank, mesh.device
        self._upcast = precond._upcast
        self._fdt = precond.factor_dtype
        self._adt = precond.dtype
        self._store = precond.dtype if precond._upcast else None
        fplans, coarse, meta = build_factor_plans(precond, ndev)
        self.meta = meta
        self.max_level = precond.max_level
        self.fplans = [rank_slice(d, r, dev, precond.factor_dtype, ("Q",))
                       for d in fplans]
        self._coarse_vsrc = torch.as_tensor(coarse["vsrc"], device=dev)
        self.dcoarse = precond.extra_plan
        self._cp_n = precond.coarse_plan.n

    def _exchange(self, vals_ext, fp, prefix, offsets, lev):
        return [C.shift(self.mesh, vals_ext[fp[f"{prefix}_send_{d}"]], d,
                        tag=f"F{lev}:{prefix}") for d in offsets]

    def compute(self, vals):
        """vals (nnz,) replicated -> this rank's halo-layout factors.
        Values are cast to the factor dtype on the way in; under factor
        upcast the factors come back in the apply dtype."""
        vals = vals.to(device=self.mesh.device, dtype=self._fdt)
        fac = self._factor(vals)
        if not self._upcast:
            return fac
        return _cast_tree(fac, self._fdt, self._adt)

    def _factor(self, vals):
        store = self._store
        d = self.dcoarse
        facs = []
        carry_ext = None          # [next values ++ consumer recvs ++ zero]
        for l in range(self.max_level):
            fp, lm = self.fplans[l], self.meta[l]
            src_ext = _cat0(vals) if l == 0 else carry_ext

            A11 = src_ext[fp["A11_idx"]]
            ni = A11.shape[-1]
            eye = torch.eye(ni, dtype=A11.dtype, device=A11.device)
            A11 = A11 + eye[None] * (~fp["int_mask"])[:, :, None]
            A11inv = _inv(A11) if store is None else _inv_chain(A11)
            A12 = src_ext[fp["A12_idx"]]
            A21 = src_ext[fp["A21_idx"]]
            A22 = src_ext[fp["A22_idx"]]
            G = torch.matmul(A11inv, A12)
            T11 = -torch.matmul(A21, G)
            if lm["apply_ot"]:
                Q = fp["Q"]
                T22q = torch.matmul(torch.matmul(Q, A22), Q)
                T11q = torch.matmul(torch.matmul(Q, T11), Q)
            else:
                T22q, T11q = A22, T11

            # Schur contributions to their owners, summed in serial order
            contrib = _cat0(T22q, T11q)
            recvs = self._exchange(contrib, fp, "sc", lm["sc_offsets"], l)
            sc_loc = torch.sum(_cat0(contrib[:-1], *recvs)[fp["sc_gather"]],
                               dim=1)

            sc_ext = _cat0(sc_loc)
            Bb = sc_ext[fp["blk_idx_loc"]]
            mb = Bb.shape[-1]
            eye_b = torch.eye(mb, dtype=Bb.dtype, device=Bb.device)
            Bb = Bb + eye_b[None] * (~fp["blk_mask"])[:, :, None]
            zr = torch.sum(torch.abs(Bb), dim=-1) == 0
            Bb = Bb + eye_b[None] * zr[:, :, None]
            # non-Vsum blocks feed only the apply: inverted in the store
            # dtype (core/preconditioner._block_inverse)
            if store is not None:
                Bb = Bb.to(store)
            blkinv = _inv(Bb)

            # RelDropDiag at the owner, the column diagonals by ppermute
            nxt_raw = sc_ext[fp["nx_pos"]]
            dr = torch.abs(_cat0(nxt_raw)[fp["dr_pos"]])
            drecv = self._exchange(_cat0(nxt_raw), fp, "dg",
                                   lm["dg_offsets"], l)
            dc = torch.abs(_cat0(nxt_raw, *drecv)[fp["dc_pos"]])
            av = torch.abs(nxt_raw)
            scal = torch.maximum(dr, dc)
            keep_off = (av > SMALL_ENTRY * scal) & (av > SMALL_ENTRY)
            keep = torch.where(fp["nx_isdiag"], av > SMALL_ENTRY, keep_off)
            nxt_loc = torch.where(keep, nxt_raw, torch.zeros_like(nxt_raw))

            # padded subdomain slots zeroed, as HaloApply.stack_factors
            sv = fp["sd_valid"][:, None, None]
            facs.append({"A11inv": A11inv * sv, "G": G * sv,
                         "A21": A21 * sv, "blkinv": blkinv})

            if l + 1 < self.max_level:
                crecv = self._exchange(_cat0(nxt_loc), fp, "cv",
                                       lm["cv_offsets"], l)
                carry_ext = _cat0(nxt_loc, *crecv)
            else:
                allv = C.all_gather(self.mesh, nxt_loc)
                vals_g = _cat0(allv)[self._coarse_vsrc]
                coarse = _coarse_factor(
                    vals_g, d["rows"], d["cols"], d["diag_entry"],
                    d["fix_rows"], self._cp_n, store_dtype=store)
        return {"levels": facs, "coarse": coarse}
