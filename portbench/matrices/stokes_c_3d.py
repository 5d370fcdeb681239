"""Stokes-C on the 3-D staggered grid: the matrices of the benchmark's 3-D
configurations.

A frozen copy of the port's generators (`stencils/generators.py`:
`stokes3d` on the C-grid, `darcy3d`; `create_testvector` is
`stokes_c_2d.testvector`), cut to the closed (non-periodic) box, so that
later changes to the program cannot move the yardstick.  NumPy and SciPy
only.

`family(spec)` gives the matrices of one configuration as a linear family
on one fixed pattern, as `stokes_c_2d.family` does: K(theta).data = v0 +
theta * v1.  Stokes has no continuation parameter: v1 = 0, theta = 0.
"""
from __future__ import annotations

import numpy as np

from portbench.matrices.stokes_c_2d import _Coo, testvector

DOF = 4


def _neighbors3d(nx, ny, nz):
    """The six neighbours of each node, -1 where the box ends."""
    n2 = nx * ny
    idx = np.arange(nx * ny * nz)
    ixy = idx % n2
    iz = idx // n2
    ix = ixy % nx
    iy = ixy // nx
    left = np.where(ix > 0, idx - 1, -1)
    right = np.where(ix < nx - 1, idx + 1, -1)
    lower = np.where(iy > 0, idx - nx, -1)
    upper = np.where(iy < ny - 1, idx + nx, -1)
    below = np.where(iz > 0, idx - n2, -1)
    above = np.where(iz < nz - 1, idx + n2, -1)
    return left, right, lower, upper, below, above


def darcy3d(nx, ny, nz, a=1.0, b=-1.0):
    """[a*I B; -B' 0] on the C-grid, dof 4 (u, v, w, p)."""
    n = nx * ny * nz * DOF
    left, right, lower, upper, below, above = _neighbors3d(nx, ny, nz)
    base = np.arange(nx * ny * nz)
    c = -b
    coo = _Coo()

    def vgid(node, var):
        node = np.asarray(node)
        return np.where(node >= 0, node * DOF + var, -1)

    for var, nb in ((0, right), (1, upper), (2, above)):
        r = base * DOF + var
        coo.add(r, r, a)
        m = nb >= 0
        coo.add(r[m], vgid(base[m], DOF - 1), -b)
        coo.add(r[m], vgid(nb[m], DOF - 1), b)
    p = base * DOF + (DOF - 1)
    for var, nb_plus, nb_minus in ((0, right, left), (1, upper, lower),
                                   (2, above, below)):
        m = nb_plus >= 0
        coo.add(p[m], vgid(base[m], var), -c)
        coo.add(p, vgid(nb_minus, var), c)
    return coo.tocsr(n)


def stokes3d(nx, ny, nz, a=None, b=1.0):
    """K = [A B; B' 0], A = -a * Laplace per velocity with the staggered
    boundary fixes (a = nx^2, b = 1 in the upstream drivers): u centred
    in y and z, v in x and z, w in x and y.  A Dirichlet velocity row
    has the diagonal 1 less the boundary compensation it gathered."""
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
    staggering = (CY | CZ, CX | CZ, CX | CY)
    # one branch per direction whose centred bit a velocity lacks: its
    # trigger neighbour missing makes the row Dirichlet, the tangential
    # pairs whose bit is set add a at the walls, and `second` cuts the
    # coupling to the boundary velocity
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
        diag_val = np.where(dir_mask, 1.0 - add_to_diag,
                            -(6.0 * a + add_to_diag))
        coo.add(rows, rows, diag_val)
        for nb in nbs:
            v = np.full(base.shape, a)
            for zt in zero_tos:
                v = np.where((nb >= 0) & (nb == zt), 0.0, v)
            keep = (nb >= 0) & ~dir_mask
            coo.add(rows[keep], nb[keep] * DOF + ivar, v[keep])
    K = (coo.tocsr(n) + darcy3d(nx, ny, nz, 0.0, -b)).tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K


def family(spec):
    """{'indptr', 'indices', 'n', 'v0', 'v1', 'theta', 'testvector'} for
    spec {'nx', 'ny', 'nz'}: the Stokes-C matrix with a = nx^2, b = 1,
    as the port's create_matrix builds it."""
    nx, ny, nz = spec["nx"], spec["ny"], spec["nz"]
    K = stokes3d(nx, ny, nz, float(nx * nx), 1.0)
    return {"indptr": K.indptr, "indices": K.indices, "n": K.shape[0],
            "v0": K.data.copy(), "v1": np.zeros_like(K.data), "theta": 0.0,
            "testvector": testvector(K)}
