"""Cartesian grid partitioner and separator-group classification.

Behavioral equivalent of the reference's CartesianPartitioner
(reference src/HYMLS_CartesianPartitioner.cpp:224-408) and the
parameter handling of BasePartitioner (src/HYMLS_BasePartitioner.cpp).

The grid is cut into sx*sy*sz boxes.  For each subdomain a lattice of
"cells" (iidx,jidx,kidx) in [-1..r]^3 is scanned; every (cell, dof)
pair yields either interior nodes, one separator group, or retained
pressure nodes, with special rules preserving the F-matrix structure:

  * pressure and 'Interior' variables never belong to a neighboring
    subdomain's separators (cells with any index == -1 are skipped),
  * pressure is interior on faces ("not in tubes"),
  * the first `retainPressures` pressure nodes of each subdomain are
    retained as singleton separator groups (one Vsum each).

All of this is pure host-side numpy setup; it runs once per grid
configuration and produces only static index sets.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import Params
from ..grid import GridInfo, VarType, X_PERIO, Y_PERIO, Z_PERIO
from .hierarchical import SepGroup, SubdomainGroups


@dataclass
class PartitionParams:
    """Partitioner controls (reference BasePartitioner::SetParameters)."""

    sx: int
    sy: int
    sz: int
    cx: int
    cy: int
    cz: int
    rx: int = -1
    ry: int = -1
    rz: int = -1
    retain_pressures: int = 1
    link_velocities: bool = True
    link_retained_nodes: bool = True
    bgrid: bool = False

    @staticmethod
    def from_params(params: Params, grid: GridInfo, level: int = 0
                    ) -> "PartitionParams":
        prec = params.sublist("Preconditioner")
        sx = prec.get("Separator Length (x)", -1) \
            if "Separator Length (x)" in prec else -1
        sy = prec.get("Separator Length (y)", -1) \
            if "Separator Length (y)" in prec else -1
        sz = prec.get("Separator Length (z)", -1) \
            if "Separator Length (z)" in prec else (-1 if grid.nz > 1 else 1)
        if sx == -1:
            sx = prec.get("Separator Length", 4)
        if sy == -1:
            sy = prec.get("Separator Length", sx)
        if sz == -1:
            sz = prec.get("Separator Length", sx)
        if sx <= 1:
            raise ValueError("Separator Length not set correctly")

        cx = prec.get("Coarsening Factor (x)", -1) \
            if "Coarsening Factor (x)" in prec else -1
        cy = prec.get("Coarsening Factor (y)", -1) \
            if "Coarsening Factor (y)" in prec else -1
        cz = prec.get("Coarsening Factor (z)", -1) \
            if "Coarsening Factor (z)" in prec else (-1 if grid.nz > 1 else 1)
        if cx == -1:
            cx = prec.get("Coarsening Factor", sx)
        if cy == -1:
            cy = prec.get("Coarsening Factor", cx)
        if cz == -1:
            cz = prec.get("Coarsening Factor", cx)

        retain_label = f"Retain Nodes at Level {level}"
        rx = ry = rz = -1
        if "Retain Nodes (x)" in prec:
            rx = prec["Retain Nodes (x)"]
        if f"{retain_label} (x)" in prec:
            rx = prec[f"{retain_label} (x)"]
        if "Retain Nodes (y)" in prec:
            ry = prec["Retain Nodes (y)"]
        if f"{retain_label} (y)" in prec:
            ry = prec[f"{retain_label} (y)"]
        if "Retain Nodes (z)" in prec:
            rz = prec["Retain Nodes (z)"]
        if f"{retain_label} (z)" in prec:
            rz = prec[f"{retain_label} (z)"]
        if rx == -1 and retain_label in prec:
            rx = prec[retain_label]
        if rx == -1:
            rx = prec.get("Retain Nodes", -1)
        if ry == -1 and retain_label in prec:
            ry = prec[retain_label]
        if ry == -1:
            ry = prec.get("Retain Nodes", -1)
        if rz == -1 and retain_label in prec:
            rz = prec[retain_label]
        if rz == -1:
            rz = prec.get("Retain Nodes", -1)

        prob = params.sublist("Problem")
        return PartitionParams(
            sx=sx, sy=sy, sz=sz, cx=cx, cy=cy, cz=cz, rx=rx, ry=ry, rz=rz,
            retain_pressures=prob.get("Retained Pressure Nodes", 1),
            link_velocities=prec.get("Eliminate Velocities Together", True),
            link_retained_nodes=prec.get(
                "Eliminate Retained Nodes Together", True),
            bgrid=prec.get("B-Grid Transform", False),
        )

    def next_level(self) -> "PartitionParams":
        """Separator length multiplies by the coarsening factor
        (reference BasePartitioner::SetNextLevelParameters)."""
        return PartitionParams(
            sx=self.sx * self.cx, sy=self.sy * self.cy, sz=self.sz * self.cz,
            cx=self.cx, cy=self.cy, cz=self.cz,
            rx=self.rx, ry=self.ry, rz=self.rz,
            retain_pressures=self.retain_pressures,
            link_velocities=self.link_velocities,
            link_retained_nodes=self.link_retained_nodes,
            bgrid=self.bgrid,
        )


def _start_end(pos: int, idx: int, idx_max: int, dim: int, mx: int,
               perio: bool) -> Optional[Tuple[int, int, int]]:
    """Range of local coordinates covered by lattice cell `idx`, or None
    if the cell is empty / outside (reference
    HYMLS_CartesianPartitioner.cpp:224-263)."""
    ln = max((mx + idx_max - 1) // idx_max, 1)

    if idx == idx_max:
        typ = 2
    elif idx >= 0:
        typ = 1
    else:
        typ = 0

    start = idx
    if idx == idx_max:
        start = mx
    elif idx > 0:
        start = min(ln * idx, mx)

    end = start + 1
    if typ == 1:
        end = min(ln * (idx + 1), mx)

    if not perio:
        if pos == 0 and idx == -1:
            return None
        if pos + mx + 1 == dim:
            if idx == idx_max:
                return None
            if idx == idx_max - 1:
                end += 1

    if start == end:
        return None
    return typ, start, end


class CartesianPartitioner:
    """Axis-aligned box partitioning of the (possibly coarsened) grid."""

    def __init__(self, grid: GridInfo, part: PartitionParams):
        self.grid = grid
        self.p = part
        self.npx = (grid.nx - 1) // part.sx + 1
        self.npy = (grid.ny - 1) // part.sy + 1
        self.npz = (grid.nz - 1) // part.sz + 1

    @property
    def num_subdomains(self) -> int:
        return self.npx * self.npy * self.npz

    def valid_subdomain_ids(self):
        return list(range(self.num_subdomains))

    def position(self, sd: int) -> Tuple[int, int, int]:
        x = (sd % self.npx) * self.p.sx
        y = ((sd // self.npx) % self.npy) * self.p.sy
        z = ((sd // (self.npx * self.npy)) % self.npz) * self.p.sz
        return x, y, z

    def subdomain_of(self, i, j, k):
        return ((np.asarray(k) // self.p.sz) * self.npy
                + np.asarray(j) // self.p.sy) * self.npx \
            + np.asarray(i) // self.p.sx

    def get_groups(self, sd: int) -> SubdomainGroups:
        """Classify all candidate nodes of subdomain `sd` into one
        interior group, separator groups, and retained pressure nodes
        (reference HYMLS_CartesianPartitioner.cpp:265-408).  Candidate
        GIDs may include nodes absent from the current level's active
        set; the Hierarchy filters them afterwards.

        Non-periodic grids are translation invariant: subdomains with
        the same extents and boundary adjacency have identical group
        structure up to an additive GID shift, so results are memoized
        by that signature (most subdomains share one entry)."""
        g = self.grid
        if g.perio:
            return self._get_groups_impl(sd)
        p = self.p
        xpos, ypos, zpos = self.position(sd)
        xmax = min(g.nx - xpos - 1, p.sx - 1)
        ymax = min(g.ny - ypos - 1, p.sy - 1)
        zmax = min(g.nz - zpos - 1, p.sz - 1)
        key = (xmax, ymax, zmax, xpos == 0, ypos == 0, zpos == 0,
               xpos + xmax + 1 == g.nx, ypos + ymax + 1 == g.ny,
               zpos + zmax + 1 == g.nz)
        base = g.dof * (xpos + g.nx * (ypos + g.ny * zpos))
        cache = getattr(self, "_group_cache", None)
        if cache is None:
            cache = self._group_cache = {}
        hit = cache.get(key)
        if hit is None:
            res = self._get_groups_impl(sd)
            cache[key] = (base, res)
            return res
        base0, res0 = hit
        d = base - base0
        return SubdomainGroups(
            interior=res0.interior + d,
            separators=[SepGroup(nodes=s.nodes + d, type=s.type)
                        for s in res0.separators])

    def _get_groups_impl(self, sd: int) -> SubdomainGroups:
        g = self.grid
        p = self.p
        xpos, ypos, zpos = self.position(sd)
        xmax = min(g.nx - xpos - 1, p.sx - 1)
        ymax = min(g.ny - ypos - 1, p.sy - 1)
        zmax = min(g.nz - zpos - 1, p.sz - 1)
        if xmax == 0 or ymax == 0 or (zmax == 0 and g.nz > 1):
            raise ValueError("Can't have a subdomain of size 1")

        iidx_max = p.rx if p.rx > 1 else 1
        jidx_max = p.ry if p.ry > 1 else 1
        kidx_max = p.rz if p.rz > 1 else 1

        interior: List[np.ndarray] = []
        seps: List[SepGroup] = []
        retained: List[int] = []
        dof = g.dof

        for kidx in range(-1, kidx_max + 1):
            kint = 0 <= kidx < kidx_max
            se = _start_end(zpos, kidx, kidx_max, g.nz, zmax,
                            bool(g.perio & Z_PERIO))
            if se is None:
                continue
            ktype, kstart, kend = se
            for jidx in range(-1, jidx_max + 1):
                jint = 0 <= jidx < jidx_max
                se = _start_end(ypos, jidx, jidx_max, g.ny, ymax,
                                bool(g.perio & Y_PERIO))
                if se is None:
                    continue
                jtype, jstart, jend = se
                for iidx in range(-1, iidx_max + 1):
                    iint = 0 <= iidx < iidx_max
                    se = _start_end(xpos, iidx, iidx_max, g.nx, xmax,
                                    bool(g.perio & X_PERIO))
                    if se is None:
                        continue
                    itype, istart, iend = se

                    # node gids of this cell, i fastest (scan order);
                    # broadcasting instead of meshgrid — this runs per
                    # cell per subdomain and dominates setup otherwise
                    gi = (np.arange(istart, iend) + xpos) % g.nx
                    gj = (np.arange(jstart, jend) + ypos) % g.ny
                    gk = (np.arange(kstart, kend) + zpos) % g.nz
                    node_base = (dof * (gi[None, None, :]
                                        + g.nx * (gj[None, :, None]
                                                  + g.ny * gk[:, None, None]))
                                 ).ravel()

                    for d in range(dof):
                        vt = g.var_types[d]
                        is_vel = vt in (VarType.VELOCITY_U,
                                        VarType.VELOCITY_V,
                                        VarType.VELOCITY_W)
                        if vt in (VarType.PRESSURE, VarType.INTERIOR) and \
                                (iidx == -1 or jidx == -1 or kidx == -1):
                            continue

                        gids = node_base + d
                        if vt == VarType.PRESSURE and \
                                len(retained) < p.retain_pressures:
                            # move the first eligible pressure nodes (in
                            # scan order) into the retained list
                            n_take = min(p.retain_pressures - len(retained),
                                         gids.size)
                            retained.extend(int(x) for x in gids[:n_take])
                            gids = gids[n_take:]
                            if gids.size == 0:
                                continue

                        to_interior = (
                            (iint and jint and kint)
                            or vt == VarType.INTERIOR
                            or (vt == VarType.PRESSURE and (
                                (iint and jint) or (iint and kint)
                                or (jint and kint)
                                or p.retain_pressures > 1)))
                        if to_interior:
                            interior.append(gids)
                        else:
                            gtype = -1000
                            if p.link_retained_nodes:
                                gtype = 2 * dof * (itype + 3 * (jtype
                                                                + 3 * ktype))
                            if not (p.link_velocities and is_vel):
                                gtype += 2 * d
                            if p.bgrid:
                                # split by xy parity (B-grid; reference
                                # nodes2 handling); parity uses the
                                # unwrapped (pre-periodic) coordinates
                                pi = np.arange(istart, iend) + xpos
                                pj = np.arange(jstart, jend) + ypos
                                par = np.broadcast_to(
                                    (pi[None, None, :] + pj[None, :, None])
                                    % 2,
                                    (kend - kstart, pj.size, pi.size)
                                ).ravel()
                                if gids.size != par.size:
                                    par = par[-gids.size:]
                                g_even = gids[par == 0]
                                g_odd = gids[par == 1]
                                if g_even.size:
                                    seps.append(SepGroup(
                                        nodes=g_even.astype(np.int64),
                                        type=gtype))
                                if g_odd.size:
                                    seps.append(SepGroup(
                                        nodes=g_odd.astype(np.int64),
                                        type=gtype + 1))
                            else:
                                seps.append(SepGroup(
                                    nodes=gids.astype(np.int64),
                                    type=gtype))

        seps = [s for s in seps if s.nodes.size > 0]
        for gid in retained:
            seps.append(SepGroup(nodes=np.array([gid], dtype=np.int64),
                                 type=-1))

        interior_nodes = (np.concatenate(interior).astype(np.int64)
                          if interior else np.empty(0, dtype=np.int64))
        return SubdomainGroups(interior=interior_nodes, separators=seps)
