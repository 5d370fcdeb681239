"""Stokes-L on the 3-D THCM grid (Galeri's Stokes-T) with Coriolis: the
matrices of the benchmark's ocean configuration.

A frozen copy of the port's generators (`stencils/generators.py`:
`stokes3d(..., grid_type="T")`, `darcy_thcm3d`, and `create_testvector`
of the Stokes-L grid), cut to the closed (non-periodic) box, so that
later changes to the program cannot move the yardstick.  NumPy and SciPy
only.

On this grid u and v sit at the cell corners of the xy plane and couple
to four pressures each; w carries no Laplacian, only the hydrostatic
balance against two pressures; u and v are coupled by a Coriolis term of
+-omega * a.  `family(spec)` gives the matrices of one configuration as
a linear family on one fixed pattern, as `stokes_c_3d.family` does:
K(theta).data = v0 + theta * v1, with v1 = 0 and theta = 0.
"""
from __future__ import annotations

import numpy as np

from portbench.matrices.stokes_c_2d import _Coo
from portbench.matrices.stokes_c_3d import _neighbors3d

DOF = 4
OMEGA = 100.0


def darcy_thcm3d(nx, ny, nz, a=1.0, b=-1.0):
    """[a*I B; -B' 0] on the THCM grid, dof 4 (u, v, w, p): u and v at
    the cell corners in the xy plane (4 pressures each), w staggered in
    z (2 pressures)."""
    n = nx * ny * nz * DOF
    left, right, lower, upper, below, above = _neighbors3d(nx, ny, nz)
    base = np.arange(nx * ny * nz)
    c = -b
    coo = _Coo()

    def second2(nb1, nb2):
        out = np.full(base.shape, -1)
        m = nb1 >= 0
        out[m] = nb2[nb1[m]]
        return out

    upper_right = second2(upper, right)
    upper_left = second2(upper, left)
    lower_right = second2(lower, right)
    lower_left = second2(lower, left)

    def pg(node):
        node = np.asarray(node)
        return np.where(node >= 0, node * DOF + 3, -1)

    def vg(node, var):
        node = np.asarray(node)
        return np.where(node >= 0, node * DOF + var, -1)

    m_ur = upper_right >= 0
    for var, signs in ((0, (-b, -b, b, b)), (1, (-b, b, -b, b))):
        r = base * DOF + var
        coo.add(r, r, a)
        coo.add(r[m_ur], pg(base[m_ur]), signs[0])
        coo.add(r[m_ur], pg(upper[m_ur]), signs[1])
        coo.add(r[m_ur], pg(right[m_ur]), signs[2])
        coo.add(r[m_ur], pg(upper_right[m_ur]), signs[3])
    w = base * DOF + 2
    coo.add(w, w, a)
    mw = above >= 0
    coo.add(w[mw], pg(base[mw]), -b)
    coo.add(w[mw], pg(above[mw]), b)

    p = base * DOF + 3
    m = upper_right >= 0
    coo.add(p[m], vg(base[m], 0), -c)
    coo.add(p[m], vg(base[m], 1), -c)
    coo.add(p[above >= 0], vg(base[above >= 0], 2), -c)
    m = upper_left >= 0
    coo.add(p[m], vg(left[m], 0), c)
    coo.add(p[m], vg(left[m], 1), -c)
    m = lower_right >= 0
    coo.add(p[m], vg(lower[m], 0), -c)
    coo.add(p[m], vg(lower[m], 1), c)
    m = lower_left >= 0
    coo.add(p[m], vg(lower_left[m], 0), c)
    coo.add(p[m], vg(lower_left[m], 1), c)
    coo.add(p, vg(below, 2), c)
    return coo.tocsr(n)


def stokes_t3d(nx, ny, nz, a=None, b=1.0):
    """K = [A B; B' 0] on the THCM grid: A = -a * Laplace for u and v
    (both centred in z) with the staggered boundary fixes and the
    Coriolis coupling -omega a (u row) and +omega a (v row), wiped on
    Dirichlet rows; w has no Laplacian (its diagonal is 0 but on
    Dirichlet rows, where it is 1)."""
    if a is None:
        a = float(nx * nx)
    n = nx * ny * nz * DOF
    base = np.arange(nx * ny * nz)
    nbs = _neighbors3d(nx, ny, nz)
    left, right, lower, upper, below, above = nbs

    def second_of(nb, table):
        out = np.full(base.shape, -1)
        m = nb > 0
        out[m] = table[nb[m]]
        return out

    CX, CY, CZ = 1, 2, 4
    staggering = (CZ, CZ, CX | CY)
    branches = (
        (CX, right, second_of(right, right),
         ((lower, upper, CY), (below, above, CZ))),
        (CY, upper, second_of(upper, upper),
         ((left, right, CX), (below, above, CZ))),
        (CZ, above, second_of(above, above),
         ((left, right, CX), (lower, upper, CY))),
    )
    coo = _Coo()
    for ivar in range(3):
        stag = staggering[ivar]
        rows = base * DOF + ivar
        w = ivar == 2
        dir_mask = np.zeros(base.shape, dtype=bool)
        add_to_diag = np.zeros(base.shape)
        zero_tos = []
        for bit, trigger, second, comps in branches:
            if stag & bit:
                continue
            own_dir = trigger < 0
            dir_mask |= own_dir
            for t0, t1, cbit in comps:
                if stag & cbit:
                    add_to_diag += np.where(
                        ~own_dir & ((t0 < 0) | (t1 < 0)), a, 0.0)
            zero_tos.append(np.where((trigger > 0) & (second < 0),
                                     trigger, -1))
        lap_diag = np.zeros(base.shape) if w else np.full(base.shape, 6.0)
        if w:
            add_to_diag = np.zeros(base.shape)
        diag_val = np.where(dir_mask, 1.0 - add_to_diag,
                            -(lap_diag * a + add_to_diag))
        coo.add(rows, rows, diag_val)
        if not w:
            for nb in nbs:
                v = np.full(base.shape, a)
                for zt in zero_tos:
                    v = np.where((nb >= 0) & (nb == zt), 0.0, v)
                keep = (nb >= 0) & ~dir_mask
                coo.add(rows[keep], nb[keep] * DOF + ivar, v[keep])
        if ivar == 0:
            coo.add(rows[~dir_mask], rows[~dir_mask] + 1, -OMEGA * a)
        elif ivar == 1:
            coo.add(rows[~dir_mask], rows[~dir_mask] - 1, OMEGA * a)
    K = (coo.tocsr(n) + darcy_thcm3d(nx, ny, nz, 0.0, -b)).tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K


def testvector(K, nx, ny):
    """The Stokes-L test vector: u alternating in x, v in y (-1, +1,
    ...), w and p ones, zeroed on the rows that couple only to
    themselves (the Dirichlet velocity rows)."""
    n = K.shape[0]
    gid = np.arange(n)
    node, var = gid // DOF, gid % DOF
    tv = np.ones(n)
    tv = np.where(var == 0, ((node % nx) % 2) * 2.0 - 1.0, tv)
    tv = np.where(var == 1, (((node // nx) % ny) % 2) * 2.0 - 1.0, tv)
    off = K.copy()
    off.setdiag(0.0)
    off.eliminate_zeros()
    tv[np.diff(off.indptr) == 0] = 0.0
    return tv


def family(spec):
    """{'indptr', 'indices', 'n', 'v0', 'v1', 'theta', 'testvector'} for
    spec {'nx', 'ny', 'nz'}: the Stokes-T matrix with a = nx^2, b = 1,
    as the port's create_matrix builds it."""
    nx, ny, nz = spec["nx"], spec["ny"], spec["nz"]
    K = stokes_t3d(nx, ny, nz, float(nx * nx), 1.0)
    return {"indptr": K.indptr, "indices": K.indices, "n": K.shape[0],
            "v0": K.data.copy(), "v1": np.zeros_like(K.data), "theta": 0.0,
            "testvector": testvector(K, nx, ny)}
