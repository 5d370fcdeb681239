"""Skew (45-degree rotated) Cartesian partitioner.

Behavioral equivalent of the reference's SkewCartesianPartitioner
(reference src/HYMLS_SkewCartesianPartitioner.cpp): subdomains are
diamonds (2D) / octahedra-like cells (3D) on two interleaved lattices.
This is the partitioner the reference uses for ALL multilevel Stokes
configurations — the diamond separators align with the staggered-grid
fluxes so the Householder reduction preserves the divergence structure
(div-free right-hand sides stay div-free).

The construction mirrors the reference:
  1. a node "template" per variable type — the set of fictitious-grid
     nodes belonging to the subdomain at the origin (buildPlane45 + 3D
     layer stacking, reference lines 28-79 / 374-565);
  2. group solving — classify template nodes by the bitmask of the 27
     neighboring subdomains that also contain them; equal masks form a
     group, mask==self is the interior (reference solveGroups, 567-654);
  3. per-subdomain placement: shift the template, clip to the grid,
     pull retained pressures out of the interior, split groups by the
     owning subdomain, and reassign boundary-wall velocities
     (reference GetGroups, 656-812).

All host-side numpy; output feeds the same Hierarchy/plan machinery as
the Cartesian partitioner.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..grid import GridInfo, VarType, X_PERIO, Y_PERIO, Z_PERIO
from .cartesian import PartitionParams
from .hierarchical import SepGroup, SubdomainGroups


def _build_plane45(first_node: int, length: int, dir_x: int, dir_y: int,
                   vtype: int) -> List[List[int]]:
    """Rows of the 45-degree diamond in the fictitious grid; returns a
    list of rows (each a list of node codes)."""
    left = first_node
    right = first_node
    height = 2 * length
    extra_layer = False

    dir1 = dir_y + dir_x
    dir2 = dir_y - dir_x

    if vtype == 0:          # u nodes
        left -= dir_x
        height += 1
        extra_layer = True
    elif vtype == 3:        # p nodes
        height += 1
        extra_layer = True

    rows: List[List[int]] = []
    for i in range(height - 1):
        row = list(range(left, right + 1, dir_x)) if dir_x > 0 else []
        rows.append(row)
        if i < length - 1:
            left += dir2
            right += dir1
        elif extra_layer and i == length - 1:
            left += dir_y
            right += dir_y
        else:
            left += dir1
            right += dir2
    return rows


class SkewCartesianPartitioner:
    """Diamond subdomains over two interleaved lattices."""

    def __init__(self, grid: GridInfo, part: PartitionParams):
        self.grid = grid
        self.p = part
        g, p = grid, part
        if p.sx != p.sy or (g.nz > 1 and p.sx != p.sz):
            raise ValueError("sx, sy and sz should be the same")
        if p.sx % 2 != 0:
            raise ValueError("sx should be even")
        if g.nx % p.sx or g.ny % p.sy or (g.nz > 1 and g.nz % p.sz):
            raise ValueError(
                f"grid {g.nx}x{g.ny}x{g.nz} not divisible by sx={p.sx}")
        self.npx = g.nx // p.sx
        self.npy = g.ny // p.sy
        self.npz = g.nz // p.sz if g.nz > 1 else 1
        self._build_template()
        self._solve_groups()

    # -- subdomain indexing (reference lines 131-240) ----------------------
    @property
    def num_subdomains(self) -> int:
        npx, npy, npz = self.npx, self.npy, self.npz
        per_layer = 2 * npx * npy + npx + npy
        n = per_layer
        if self.grid.nz > 1:
            n += per_layer * npz
        return max(n, 1)

    def position(self, sd: int) -> Tuple[int, int, int, bool]:
        """(x, y, z, valid); valid=False for periodic wrap duplicates."""
        g, sx = self.grid, self.p.sx
        npx, npy = self.npx, self.npy
        per_layer = 2 * npx * npy + npx + npy
        per_row = 2 * npx + 1
        Z = sd // per_layer if per_layer > 0 else 0
        Y = ((sd - Z * per_layer) // per_row) * 2 - 1
        X = ((sd - Z * per_layer) % per_row) * 2
        if X >= npx * 2:
            X -= npx * 2 + 1
            Y += 1
        x = (X * sx) // 2
        y = (Y * sx) // 2 + sx // 2
        z = Z * sx
        valid = True
        if x == g.nx - sx // 2 and g.perio & X_PERIO:
            valid = False
        if y == g.ny and g.perio & Y_PERIO:
            valid = False
        if z == g.nz and g.perio & Z_PERIO:
            valid = False
        return x, y, z, valid

    def subdomain_of(self, x, y, z):
        """Owning subdomain id for grid coordinates (vectorized);
        reference GetSubdomainID lines 163-208."""
        g, sx = self.grid, self.p.sx
        npx, npy, npz = self.npx, self.npy, self.npz
        x = np.asarray(x)
        y = np.asarray(y)
        z = np.asarray(z)

        dir1 = npx + 1
        dir2 = npx
        dir3 = 2 * npx * npy + npx + npy

        xcube = x // sx
        ycube = y // sx
        zcube = z // sx

        sd = zcube * dir3 + ycube * (dir2 + dir1) + xcube

        xr = x - (xcube * sx - 1)
        yr = y - ycube * sx
        zr = z - zcube * sx

        front = yr < sx - xr
        right = yr < xr
        below = np.where(right, zr <= sx + yr - xr, zr <= yr - xr)

        sd = sd + np.where(front, 0, dir1)
        sd = sd + np.where(right, 0, dir2)
        sd = sd + np.where(below, 0, dir3)

        if g.perio & X_PERIO:
            sd = sd - np.where(~front & right & (xcube == npx - 1), dir2, 0)
        if g.perio & Y_PERIO:
            sd = sd - np.where(~front & ~right & (ycube == npy - 1),
                               dir3 - dir2, 0)
        if g.perio & Z_PERIO:
            sd = sd - np.where(~below & (zcube == npz - 1), npz * dir3, 0)
        return sd

    def valid_subdomain_ids(self):
        """Subdomain ids excluding periodic wrap duplicates (reference
        CreateSubdomainMap skips positions flagged by
        GetSubdomainPosition)."""
        out = []
        for sd in range(self.num_subdomains):
            if self.position(sd)[3]:
                out.append(sd)
        return out

    # -- template construction (reference getTemplate, lines 374-565) -------
    def _build_template(self):
        g, p = self.grid, self.p
        sx = p.sx
        dof = g.dof
        nx = sx * 4
        dir_x = dof
        dir_y = dof * nx
        dir_z = dof * nx * nx

        first_node = [dof * sx // 2 + dir_y + dir_z * sx,
                      dof * sx // 2 + dir_z * sx,
                      dof * sx // 2 + dir_y + dir_z * sx,
                      dof * sx // 2 + dir_y + dir_z * sx]
        base_length = [sx // 2, sx // 2 + 1, sx // 2 + 1, sx // 2]
        type_array = [VarType.VELOCITY_U, VarType.VELOCITY_V,
                      VarType.VELOCITY_W, VarType.PRESSURE]

        nodes: List[List[List[int]]] = []
        for t in range(4):
            nodes.append([[] for _ in range(2 * sx + 1)])
            rows = _build_plane45(first_node[t], base_length[t],
                                  dir_x, dir_y, t)
            plane = [n for row in rows for n in row]
            nodes[t][sx] = list(plane)

            if g.nz <= 1:
                continue

            # 3D: build the layers above/below the central plane
            ptr = [0]
            for row in rows:
                ptr.append(ptr[-1] + len(row))
            row_length = [ptr[i + 1] - ptr[i] - 1 for i in range(len(rows))]

            top = list(plane)
            bottom: List[int] = []
            active = list(range(base_length[t]))
            offset = [row_length[i] for i in active]

            for i in range(sx):
                for j in range(len(active)):
                    val = plane[ptr[active[j]] + offset[j]]
                    bottom.append(val)
                    top = [v for v in top if v != val]

                if type_array[t] == VarType.VELOCITY_W:
                    if i % 2 == 1:
                        for v in top:
                            nodes[t][sx + i].append(v + i * dir_z - dir_y)
                        for v in top:
                            nodes[t][sx + 1 + i].append(v + (i + 1) * dir_z)
                    else:
                        for v in bottom:
                            nodes[t][i].append(v - (sx - i) * dir_z)
                        if i > 0:
                            for v in bottom:
                                nodes[t][i - 1].append(
                                    v - (sx - i + 1) * dir_z - dir_y)
                        else:
                            for v in plane:
                                nodes[t][sx - 1].append(v - dir_z - dir_y)
                else:
                    is_p = 1 if type_array[t] == VarType.PRESSURE else 0
                    if i < sx - is_p:
                        for v in bottom:
                            nodes[t][i + is_p].append(
                                v - (sx - i - is_p) * dir_z)
                    for v in top:
                        nodes[t][sx + 1 + i].append(v + (i + 1) * dir_z)

                if i < sx - 1:
                    offset = [o - 1 for o in offset]
                    if type_array[t] == VarType.PRESSURE:
                        if offset[0] < 0:
                            active.append(active[-1] + 1)
                            active.pop(0)
                            offset.append(row_length[active[-1]])
                            offset.pop(0)
                    else:
                        if offset[0] < 0:
                            active.pop(0)
                            offset.pop(0)
                        elif offset[0] == 0:
                            active.append(active[-1] + 1)
                            offset.append(row_length[active[-1]])

        # remove the superfluous first/last walls (reference 503-515)
        nodes[0] = nodes[0][1:-1]
        nodes[1] = nodes[1][1:-1]
        nodes[2] = nodes[2][:-1]
        nodes[3] = nodes[3][1:-1]

        # merge per-dof (reference 527-562)
        template: List[List[int]] = [[]]
        w_nodes = [list(layer) for layer in nodes[2]]
        for d in range(dof):
            if g.var_types[d] == VarType.VELOCITY_W:
                template[0].extend(v + d for v in w_nodes[0])
                w_nodes = w_nodes[1:]
                break
        for j in range(2 * sx - 1):
            layer: List[int] = []
            for d in range(dof):
                for t in range(4):
                    if g.var_types[d] == type_array[t]:
                        src = w_nodes if t == 2 else nodes[t]
                        layer.extend(v + d for v in src[j])
            layer.sort()
            template.append(layer)
        self.template = template

    # -- group solving (reference solveGroups, lines 567-654) ---------------
    def _solve_groups(self):
        g, p = self.grid, self.p
        sx, dof = p.sx, g.dof
        nx = sx * 4
        dir_x = dof * sx
        dir_y = dof * nx * sx
        dir_z = dof * nx * nx * sx
        first = dir_x + dir_y + dir_z

        dir1 = (dir_y + dir_x) // 2
        dir2 = (dir_y - dir_x) // 2 + dir_z
        dir3 = dir_z
        positions = [0, -dir3, dir3, -dir2, -dir2 - dir3, -dir2 + dir3,
                     dir2, dir2 - dir3, dir2 + dir3, -dir1, -dir1 - dir3,
                     -dir1 + dir3, -dir1 - dir2, -dir1 - dir2 - dir3,
                     -dir1 - dir2 + dir3, -dir1 + dir2, -dir1 + dir2 - dir3,
                     -dir1 + dir2 + dir3, dir1, dir1 - dir3, dir1 + dir3,
                     dir1 - dir2, dir1 - dir2 - dir3, dir1 - dir2 + dir3,
                     dir1 + dir2, dir1 + dir2 - dir3, dir1 + dir2 + dir3]

        temp_list = np.array([v + first for layer in self.template
                              for v in layer], dtype=np.int64)
        sorted_list = np.sort(temp_list)

        # membership bitmask over the 27 shifted copies
        masks = np.zeros(temp_list.size, dtype=np.int64)
        for i, pos in enumerate(positions):
            q = temp_list - pos
            idx = np.searchsorted(sorted_list, q)
            idx = np.minimum(idx, sorted_list.size - 1)
            hit = sorted_list[idx] == q
            masks |= hit.astype(np.int64) << i

        groups: List[List[int]] = [[]]
        group_masks: List[int] = [1]
        mask_to_idx: Dict[int, int] = {1: 0}
        for node, m in zip(temp_list.tolist(), masks.tolist()):
            gi = mask_to_idx.get(m)
            if gi is None:
                gi = len(groups)
                mask_to_idx[m] = gi
                groups.append([])
                group_masks.append(m)
            groups[gi].append(node)

        # split by dof, keep interior whole (reference 641-651)
        self.tmpl_groups: List[List[List[int]]] = [[groups[0]]]
        for grp in groups[1:]:
            by_dof: List[List[int]] = [[] for _ in range(dof)]
            for node in grp:
                by_dof[node % dof].append(node)
            self.tmpl_groups.append(by_dof)

        # precompute fictitious-grid coordinates per group (vectorized
        # placement in get_groups)
        nx_f = sx * 4
        self._tmpl_coords: List[List[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]]] = []
        for cat in self.tmpl_groups:
            cc = []
            for grp in cat:
                a = np.asarray(grp, dtype=np.int64)
                var = a % dof
                sp = a // dof
                cc.append((var, sp % nx_f, (sp // nx_f) % nx_f,
                           sp // (nx_f * nx_f)))
            self._tmpl_coords.append(cc)

    # -- per-subdomain groups (reference GetGroups, lines 656-812) ----------
    def get_groups(self, sd: int) -> SubdomainGroups:
        """Memoized wrapper: on non-periodic grids, subdomains on the
        same sublattice (positions mod sx) with the same wall-clamped
        distances are exact translates — group structure is identical
        up to an additive GID shift (cf. the Cartesian memoization).
        Verified against the direct path in tests/test_skew_partition."""
        g, p = self.grid, self.p
        if g.perio:
            return self._get_groups_impl(sd)
        sx, dof = p.sx, g.dof
        sdx, sdy, sdz, _valid = self.position(sd)
        C = 4 * sx + 4          # conservative template radius
        key = (sdx % sx, sdy % sx, sdz % sx,
               min(sdx, C), min(g.nx - sdx, C),
               min(sdy, C), min(g.ny - sdy, C),
               min(sdz, C), min(g.nz - sdz, C))
        cache = getattr(self, "_group_cache", None)
        if cache is None:
            cache = self._group_cache = {}
        hit = cache.get(key)
        if hit is None:
            res = self._get_groups_impl(sd)
            cache[key] = ((sdx, sdy, sdz), res)
            return res
        (x0, y0, z0), res0 = hit
        d = dof * ((sdx - x0) + g.nx * ((sdy - y0) + g.ny * (sdz - z0)))
        return SubdomainGroups(
            interior=res0.interior + d,
            separators=[SepGroup(nodes=s.nodes + d, type=s.type)
                        for s in res0.separators])

    def _get_groups_impl(self, sd: int) -> SubdomainGroups:
        g, p = self.grid, self.p
        sx, dof = p.sx, g.dof
        nx = sx * 4
        sdx, sdy, sdz, _valid = self.position(sd)

        placed: List[List[np.ndarray]] = []
        for cat in self._tmpl_coords:
            placed.append([])
            for var, xf, yf, zf in cat:
                x = xf + (sdx - 1 - sx)
                y = yf + (sdy - 1 - 3 * sx // 2)
                z = zf + (sdz - 2 * sx)
                if g.perio & X_PERIO:
                    x = (x + g.nx) % g.nx
                if g.perio & Y_PERIO:
                    y = (y + g.ny) % g.ny
                if g.perio & Z_PERIO:
                    z = (z + g.nz) % g.nz
                ok = (x >= 0) & (x < g.nx) & (y >= 0) & (y < g.ny) & \
                    (z >= 0) & (z < g.nz)
                placed[-1].append(
                    (var + dof * (x + g.nx * (y + g.ny * z)))[ok])

        # retained pressures: first pressure nodes of the interior
        interior = placed[0][0]
        var_t = np.array([int(t) for t in g.var_types])
        retained: List[int] = []
        if p.retain_pressures > 0:
            is_p = var_t[interior % dof] == int(VarType.PRESSURE)
            p_idx = np.nonzero(is_p)[0][:p.retain_pressures]
            retained = interior[p_idx].tolist()
            keep = np.ones(interior.size, dtype=bool)
            keep[p_idx] = False
            interior = interior[keep]

        separators: List[SepGroup] = []
        gtype = 1
        all_cats = placed[1:] + [[np.array([r], dtype=np.int64)]
                                 for r in retained]
        for cat in all_cats:
            gtype += 1
            for grp in cat:
                if grp.size == 0:
                    continue
                i, j, k, var = g.ind2sub(grp)
                owner = self.subdomain_of(i, j, k)
                # split by owning subdomain, ascending owner id
                # (reference uses std::map ordering)
                for own in np.unique(owner):
                    sub = grp[owner == own]
                    sg = SepGroup(nodes=sub,
                                  type=gtype if p.link_velocities else -1)
                    if p.rx > 1:
                        if not p.link_velocities:
                            gtype += 1
                        ln = sub.size
                        new_len = max((ln + p.rx - 1) // p.rx, 1)
                        n_parts = (ln - 1) // new_len + 1
                        for q in range(n_parts):
                            part_nodes = sub[q * new_len:(q + 1) * new_len]
                            t = gtype if (p.link_velocities
                                          or p.link_retained_nodes) else -1
                            separators.append(
                                SepGroup(nodes=part_nodes, type=t))
                    else:
                        separators.append(sg)

        # move boundary-wall velocities out of the separators
        # (reference 770-806)
        extra_interior: List[int] = []
        for sg in separators:
            nodes = sg.nodes
            if nodes.size == 0:
                continue
            i, j, k, var = g.ind2sub(nodes)
            vts = var_t[var]
            drop = np.zeros(nodes.size, dtype=bool)
            if dof > 1 and not (g.perio & X_PERIO):
                drop |= (i == g.nx - 1) & (vts == int(VarType.VELOCITY_U))
            if dof > 1 and not (g.perio & Y_PERIO):
                drop |= (j == g.ny - 1) & (vts == int(VarType.VELOCITY_V))
            if g.nz > 1 and dof > 1 and not (g.perio & Z_PERIO):
                drop |= (k == g.nz - 1) & (vts == int(VarType.VELOCITY_W))
            if drop.any():
                owner = self.subdomain_of(i[drop], j[drop], k[drop])
                mine = nodes[drop][owner == sd]
                extra_interior.extend(mine.tolist())
                sg.nodes = nodes[~drop]

        separators = [s for s in separators if s.nodes.size > 0]
        if extra_interior:
            interior = np.concatenate(
                [interior, np.array(extra_interior, dtype=np.int64)])
        interior = np.sort(interior)

        return SubdomainGroups(interior=interior, separators=separators)
