"""Stokes-C on the 2-D staggered grid, with the driven cavity's linearized
convection: the matrices of the benchmark's configurations.

A frozen copy of the port's generators (`stencils/generators.py`:
`stokes2d`, `darcy2d`, `create_testvector`; `stencils/navier_stokes.py`:
`cavity_jacobian`), cut to closed (non-periodic) boxes, so that later
changes to the program cannot move the yardstick.  NumPy and SciPy only.

`family(spec)` gives the matrices of one configuration as a linear family
on one fixed pattern: K(theta).data = v0 + theta * v1, with theta the
Reynolds number.  Stokes (Re 0) has v1 = 0.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

DOF = 3


def _neighbors2d(nx, ny):
    idx = np.arange(nx * ny)
    ix = idx % nx
    iy = idx // nx
    left = np.where(ix > 0, idx - 1, -1)
    right = np.where(ix < nx - 1, idx + 1, -1)
    lower = np.where(iy > 0, idx - nx, -1)
    upper = np.where(iy < ny - 1, idx + nx, -1)
    return left, right, lower, upper


class _Coo:
    def __init__(self):
        self.rows, self.cols, self.vals = [], [], []

    def add(self, r, c, v):
        """Append the entries whose column is >= 0."""
        r = np.asarray(r)
        c = np.asarray(c)
        v = np.broadcast_to(np.asarray(v, dtype=np.float64), r.shape)
        m = c >= 0
        self.rows.append(r[m])
        self.cols.append(c[m])
        self.vals.append(v[m])

    def tocsr(self, n):
        A = sp.coo_matrix((np.concatenate(self.vals),
                           (np.concatenate(self.rows),
                            np.concatenate(self.cols))), shape=(n, n)).tocsr()
        A.sum_duplicates()
        A.sort_indices()
        return A


def darcy2d(nx, ny, a=1.0, b=-1.0):
    """[a*I B; -B' 0] on the C-grid, dof 3 (u, v, p)."""
    n = nx * ny * DOF
    left, right, lower, upper = _neighbors2d(nx, ny)
    base = np.arange(nx * ny)
    c = -b
    coo = _Coo()

    def vgid(node, var):
        node = np.asarray(node)
        return np.where(node >= 0, node * DOF + var, -1)

    u = base * DOF
    coo.add(u, u, a)
    mu = right >= 0
    coo.add(u[mu], vgid(base[mu], 2), -b)
    coo.add(u[mu], vgid(right[mu], 2), b)
    v = base * DOF + 1
    coo.add(v, v, a)
    mv = upper >= 0
    coo.add(v[mv], vgid(base[mv], 2), -b)
    coo.add(v[mv], vgid(upper[mv], 2), b)
    p = base * DOF + 2
    coo.add(p[right >= 0], vgid(base[right >= 0], 0), -c)
    coo.add(p[upper >= 0], vgid(base[upper >= 0], 1), -c)
    coo.add(p, vgid(left, 0), c)
    coo.add(p, vgid(lower, 1), c)
    return coo.tocsr(n)


def stokes2d(nx, ny, a=None, b=1.0):
    """K = [A B; B' 0], A = -a * Laplace per velocity with the staggered
    boundary fixes (a = nx^2, b = 1 in the upstream drivers)."""
    if a is None:
        a = float(nx * nx)
    n = nx * ny * DOF
    base = np.arange(nx * ny)
    left, right, lower, upper = _neighbors2d(nx, ny)

    def second_of(nb, table):
        out = np.full(base.shape, -1)
        m = nb > 0
        out[m] = table[nb[m]]
        return out

    coo = _Coo()
    darcy = darcy2d(nx, ny, 0.0, -b)
    specs = ((0, right, second_of(right, right), (lower, upper)),
             (1, upper, second_of(upper, upper), (left, right)))
    lap_nbs = (left, right, lower, upper)
    for ivar, dirn, second, tang in specs:
        rows = base * DOF + ivar
        dir_mask = dirn < 0
        lap_diag = np.full(base.shape, 4.0)
        add_to_diag = np.where((tang[0] < 0) | (tang[1] < 0), a, 0.0)
        add_to_diag = np.where(dir_mask, 0.0, add_to_diag)
        diag_val = np.where(dir_mask, -(b / (a * a)) * a,
                            -(lap_diag * a + add_to_diag))
        coo.add(rows, rows, diag_val)
        zero_to = np.where((dirn > 0) & (second < 0), dirn, -1)
        for nb in lap_nbs:
            v = np.where((nb >= 0) & (nb == zero_to), 0.0, a)
            keep = (nb >= 0) & ~dir_mask
            coo.add(rows[keep], nb[keep] * DOF + ivar, v[keep])
    K = (coo.tocsr(n) + darcy).tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K


def _psi_derivs(x, y):
    """The regularized cavity vortex psi = 16 x^2(1-x)^2 y^2(1-y)^2:
    u0 = dpsi/dy, v0 = -dpsi/dx and their derivatives."""
    fx = x * x * (1 - x) ** 2
    fy = y * y * (1 - y) ** 2
    dfx = 2 * x * (1 - x) * (1 - 2 * x)
    dfy = 2 * y * (1 - y) * (1 - 2 * y)
    d2fx = 2 * (1 - 6 * x + 6 * x * x)
    d2fy = 2 * (1 - 6 * y + 6 * y * y)
    return (16 * fx * dfy, -16 * dfx * fy, 16 * dfx * dfy, 16 * fx * d2fy,
            -16 * d2fx * fy, -16 * dfx * dfy)


def cavity_jacobian(nx, ny, re=0.0):
    """K(Re): the Stokes operator plus Re times the linearized convection
    around the cavity vortex, central differences on the C-grid."""
    a = float(nx * nx)
    K = stokes2d(nx, ny, a, 1.0)
    if re == 0.0:
        return K
    h = 1.0 / nx
    base = np.arange(nx * ny)
    ix = base % nx
    iy = base // nx
    coo = _Coo()

    def gid(i, j, d):
        i = np.asarray(i)
        j = np.asarray(j)
        ok = (i >= 0) & (i < nx) & (j >= 0) & (j < ny)
        ok &= (i < nx - 1) if d == 0 else (j < ny - 1)
        return np.where(ok, (i + nx * j) * DOF + d, -1)

    c = re * nx
    u0, v0, du0dx, du0dy, _, _ = _psi_derivs((ix + 1.0) * h, (iy + 0.5) * h)
    rows_u = base * DOF
    live_u = ix < nx - 1

    def addu(cols, vals):
        m = live_u & (cols >= 0)
        coo.add(rows_u[m], cols[m], vals[m])

    addu(gid(ix + 1, iy, 0), c * u0 / 2)
    addu(gid(ix - 1, iy, 0), -c * u0 / 2)
    addu(gid(ix, iy + 1, 0), c * v0 / 2)
    addu(gid(ix, iy - 1, 0), -c * v0 / 2)
    addu(gid(ix, iy, 0), re * du0dx)
    for (di, dj) in ((0, 0), (1, 0), (0, -1), (1, -1)):
        addu(gid(ix + di, iy + dj, 1), re * du0dy / 4)

    u0v, v0v, _, _, dv0dx, dv0dy = _psi_derivs((ix + 0.5) * h,
                                               (iy + 1.0) * h)
    rows_v = base * DOF + 1
    live_v = iy < ny - 1

    def addv(cols, vals):
        m = live_v & (cols >= 0)
        coo.add(rows_v[m], cols[m], vals[m])

    addv(gid(ix + 1, iy, 1), c * u0v / 2)
    addv(gid(ix - 1, iy, 1), -c * u0v / 2)
    addv(gid(ix, iy + 1, 1), c * v0v / 2)
    addv(gid(ix, iy - 1, 1), -c * v0v / 2)
    addv(gid(ix, iy, 1), re * dv0dy)
    for (di, dj) in ((0, 0), (-1, 0), (0, 1), (-1, 1)):
        addv(gid(ix + di, iy + dj, 0), re * dv0dx / 4)

    K = (K + coo.tocsr(K.shape[0])).tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K


def testvector(K):
    """Ones, zeroed on the rows that couple only to themselves (the
    Dirichlet velocity rows): the Stokes-C test vector."""
    tv = np.ones(K.shape[0])
    off = K.copy()
    off.setdiag(0.0)
    off.eliminate_zeros()
    tv[np.diff(off.indptr) == 0] = 0.0
    return tv


def family(spec):
    """{'indptr', 'indices', 'n', 'v0', 'v1', 'theta', 'testvector'} for
    spec {'nx', 'ny', 'reynolds'}: K(theta) on the pattern of K(Re) with
    data v0 + theta * v1, exact at theta 0 and within rounding of K(Re) at
    theta = Re."""
    nx, ny, re = spec["nx"], spec["ny"], float(spec["reynolds"])
    K = cavity_jacobian(nx, ny, re)
    n = K.shape[0]
    v0 = K.data.copy()
    v1 = np.zeros_like(v0)
    if re != 0.0:
        K0 = cavity_jacobian(nx, ny, 0.0)
        rows = np.repeat(np.arange(n), np.diff(K.indptr))
        rows0 = np.repeat(np.arange(n), np.diff(K0.indptr))
        keys = rows.astype(np.int64) * n + K.indices
        keys0 = rows0.astype(np.int64) * n + K0.indices
        at = np.searchsorted(keys, keys0)
        if not np.array_equal(keys[at], keys0):
            raise ValueError("the Stokes pattern is not inside K(Re)'s")
        v0 = np.zeros_like(K.data)
        v0[at] = K0.data
        v1 = (K.data - v0) / re
    return {"indptr": K.indptr, "indices": K.indices, "n": n, "v0": v0,
            "v1": v1, "theta": re, "testvector": testvector(K)}
