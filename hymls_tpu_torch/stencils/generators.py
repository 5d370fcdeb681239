"""Test-operator generators on structured (staggered) grids.

Behavioral equivalents of the reference's GaleriExt stencil assembly
(reference src/GaleriExt_Stokes2D.h, GaleriExt_Stokes3D.h,
GaleriExt_Darcy2D.h, GaleriExt_Darcy3D.h, GaleriExt_Cross2DN.h,
GaleriExt_Periodic.cpp and HYMLS_MainUtils.cpp:260-348) — implemented
as vectorized numpy assembly into scipy CSR (the host-side symbolic
format of this framework; device ops consume only the value array).

Conventions (all matching the reference):
  * node gid = var + dof * (i + nx*(j + ny*k))
  * Laplace ("Laplace" equations): 5/7-point stencil with Dirichlet
    boundaries by omission, scaled by -1 (negative definite,
    HYMLS_MainUtils.cpp:341-346).
  * Stokes-C: K = [A B; B' 0] with A = -a*Laplace per velocity with
    staggered-grid boundary fixes, B the staggered gradient, and the
    divergence rows -B'.  a = nx*nx, b = 1 in the drivers.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..grid import NO_PERIO, X_PERIO, Y_PERIO, Z_PERIO
from ..config import Params


# ---------------------------------------------------------------------------
# neighbor index helpers (GaleriExt_Periodic.cpp semantics, vectorized).
# Node indices here are *scalar grid node* ids (no dof), -1 == missing.
# ---------------------------------------------------------------------------

def _neighbors2d(nx, ny, perio):
    idx = np.arange(nx * ny)
    ix = idx % nx
    iy = idx // nx
    left = np.where(ix > 0, idx - 1, -1)
    right = np.where(ix < nx - 1, idx + 1, -1)
    lower = np.where(iy > 0, idx - nx, -1)
    upper = np.where(iy < ny - 1, idx + nx, -1)
    if perio & X_PERIO:
        left = iy * nx + (ix - 1) % nx
        right = iy * nx + (ix + 1) % nx
    if perio & Y_PERIO:
        lower = ((iy - 1) % ny) * nx + ix
        upper = ((iy + 1) % ny) * nx + ix
    return left, right, lower, upper


def _neighbors3d(nx, ny, nz, perio):
    n2 = nx * ny
    idx = np.arange(nx * ny * nz)
    ixy = idx % n2
    iz = idx // n2
    l2, r2, lo2, up2 = _neighbors2d(nx, ny, perio)
    left = np.where(l2[ixy] >= 0, l2[ixy] + iz * n2, -1)
    right = np.where(r2[ixy] >= 0, r2[ixy] + iz * n2, -1)
    lower = np.where(lo2[ixy] >= 0, lo2[ixy] + iz * n2, -1)
    upper = np.where(up2[ixy] >= 0, up2[ixy] + iz * n2, -1)
    if perio & Z_PERIO:
        below = (idx - n2) % (n2 * nz)
        above = (idx + n2) % (n2 * nz)
    else:
        below = np.where(iz > 0, idx - n2, -1)
        above = np.where(iz < nz - 1, idx + n2, -1)
    return left, right, lower, upper, below, above


class _Coo:
    """Tiny COO accumulator."""

    def __init__(self):
        self.rows = []
        self.cols = []
        self.vals = []

    def add(self, r, c, v):
        """Append entries where c >= 0 (missing neighbors are skipped)."""
        r = np.asarray(r)
        c = np.asarray(c)
        v = np.broadcast_to(np.asarray(v, dtype=np.float64), r.shape)
        m = c >= 0
        self.rows.append(r[m])
        self.cols.append(c[m])
        self.vals.append(v[m])

    def tocsr(self, n) -> sp.csr_matrix:
        rows = np.concatenate(self.rows)
        cols = np.concatenate(self.cols)
        vals = np.concatenate(self.vals)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        A.sum_duplicates()
        A.sort_indices()
        return A


# ---------------------------------------------------------------------------
# Laplace (Galeri Cross2D/Cross3D with a=2*dim, b..=-1, then scaled by -1)
# ---------------------------------------------------------------------------

def _cross2d(nx, ny, a, b, c, d, e, perio=NO_PERIO, neumann=False):
    left, right, lower, upper = _neighbors2d(nx, ny, perio)
    idx = np.arange(nx * ny)
    coo = _Coo()
    diag = np.full(nx * ny, float(a))
    if neumann:
        # missing neighbor coefficients fold into the diagonal
        # (reference GaleriExt_Cross2DN.h:77-122)
        diag += np.where(left < 0, b, 0.0) + np.where(right < 0, c, 0.0)
        diag += np.where(lower < 0, d, 0.0) + np.where(upper < 0, e, 0.0)
    coo.add(idx, idx, diag)
    coo.add(idx, left, b)
    coo.add(idx, right, c)
    coo.add(idx, lower, d)
    coo.add(idx, upper, e)
    return coo.tocsr(nx * ny)


def _cross3d(nx, ny, nz, a, bc, perio=NO_PERIO, neumann=False):
    left, right, lower, upper, below, above = _neighbors3d(nx, ny, nz, perio)
    idx = np.arange(nx * ny * nz)
    coo = _Coo()
    diag = np.full(idx.shape, float(a))
    if neumann:
        for nb in (left, right, lower, upper, below, above):
            diag += np.where(nb < 0, bc, 0.0)
    coo.add(idx, idx, diag)
    for nb in (left, right, lower, upper, below, above):
        coo.add(idx, nb, bc)
    return coo.tocsr(idx.size)


def laplace2d(nx, ny, perio=NO_PERIO) -> sp.csr_matrix:
    """-1 * (5-point Laplacian), Dirichlet boundaries by omission."""
    return -_cross2d(nx, ny, 4.0, -1.0, -1.0, -1.0, -1.0, perio)


def laplace3d(nx, ny, nz, perio=NO_PERIO) -> sp.csr_matrix:
    return -_cross3d(nx, ny, nz, 6.0, -1.0, perio)


def stretched2d(nx, ny, eps) -> sp.csr_matrix:
    """Anisotropic (stretched-grid) diffusion: 5-point stencil with
    y-couplings scaled by eps (the role of the Galeri 'Stretched2D'
    operator in the reference's deflation tests,
    testSuite/integration_tests/deflation1.xml)."""
    a = 2.0 + 2.0 * abs(eps)
    return -_cross2d(nx, ny, a, -1.0, -1.0, -eps, -eps)


def laplace2d_neumann(nx, ny) -> sp.csr_matrix:
    """-1 * Neumann Laplacian (reference 'Laplace Neumann' Galeri label)."""
    return -_cross2d(nx, ny, 4.0, -1.0, -1.0, -1.0, -1.0, NO_PERIO,
                     neumann=True)


def laplace3d_neumann(nx, ny, nz) -> sp.csr_matrix:
    """7-point Neumann Laplacian (reference GaleriExt_Cross3DN.h)."""
    return -_cross3d(nx, ny, nz, 6.0, -1.0, NO_PERIO, neumann=True)


def uniflow2d(nx, ny, conv=1.0, diff=1.0, alpha=0.0,
              perio=NO_PERIO) -> sp.csr_matrix:
    """Convection-diffusion with a uniform flow field at angle `alpha`
    (behavioral equivalent of the Galeri 'UniFlow2D' operator used by
    the reference's convdiff.xml demo): central differences of
    -diff*Lap(u) + conv*(cos a, sin a).grad(u) on the unit square,
    h = 1/(n+1), Dirichlet by omission."""
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    vx = conv * np.cos(alpha)
    vy = conv * np.sin(alpha)
    ce = diff / hx**2
    cn = diff / hy**2
    # -1*(...) convention matches laplace2d (negative-definite operator)
    return -_cross2d(nx, ny,
                     2.0 * ce + 2.0 * cn,
                     -ce - vx / (2.0 * hx),   # west  (b)
                     -ce + vx / (2.0 * hx),   # east  (c)
                     -cn - vy / (2.0 * hy),   # south (d)
                     -cn + vy / (2.0 * hy),   # north (e)
                     perio)


def star3d(nx, ny, nz, a, b, c, d, perio=NO_PERIO) -> sp.csr_matrix:
    """27-point stencil: center a, face-neighbours b, edge-neighbours
    c, corner-neighbours d (reference GaleriExt_Star3D.h:40-200;
    Dirichlet by omission, optional periodic wrap)."""
    left, right, lower, upper, below, above = _neighbors3d(nx, ny, nz, perio)
    idx = np.arange(nx * ny * nz)
    n = idx.size
    coo = _Coo()
    coo.add(idx, idx, np.full(n, float(a)))

    def compose(n1, n2):
        """neighbour-of-neighbour with boundary propagation (-1)."""
        valid = n1 >= 0
        out = np.where(valid, n2[np.clip(n1, 0, n - 1)], -1)
        return np.where((n1 >= 0) & (out >= 0), out, -1)

    x = (left, right)
    y = (lower, upper)
    z = (below, above)
    for nb in x + y + z:                      # 6 faces
        coo.add(idx, nb, np.full(n, float(b)))
    for pair in ((x, y), (x, z), (y, z)):     # 12 edges
        for n1 in pair[0]:
            for n2 in pair[1]:
                coo.add(idx, compose(n1, n2), np.full(n, float(c)))
    for n1 in x:                              # 8 corners
        for n2 in y:
            for n3 in z:
                coo.add(idx, compose(compose(n1, n2), n3),
                        np.full(n, float(d)))
    return coo.tocsr(n)


# ---------------------------------------------------------------------------
# Darcy / Stokes on the C-grid
# ---------------------------------------------------------------------------

def darcy2d(nx, ny, a=1.0, b=-1.0, perio=NO_PERIO) -> sp.csr_matrix:
    """[a*I B; -B' 0] on the 2D C-grid, dof=3 (u,v,p).

    Matches reference src/GaleriExt_Darcy2D.h:48-155 (c=-b convention:
    velocity rows get (-b, +b) pressure gradient; pressure rows get the
    negative divergence +c/-c entries)."""
    dof = 3
    n = nx * ny * dof
    left, right, lower, upper = _neighbors2d(nx, ny, perio)
    base = np.arange(nx * ny)
    c = -b
    coo = _Coo()

    def vgid(node, var):
        return np.where(np.asarray(node) >= 0, np.asarray(node) * dof + var, -1)

    # u rows
    u = base * dof + 0
    coo.add(u, u, a)
    mu = right >= 0
    coo.add(u[mu], vgid(base[mu], 2), -b)
    coo.add(u[mu], vgid(right[mu], 2), b)
    # v rows
    v = base * dof + 1
    coo.add(v, v, a)
    mv = upper >= 0
    coo.add(v[mv], vgid(base[mv], 2), -b)
    coo.add(v[mv], vgid(upper[mv], 2), b)
    # p rows (divergence)
    p = base * dof + 2
    coo.add(p[right >= 0], vgid(base[right >= 0], 0), -c)
    coo.add(p[upper >= 0], vgid(base[upper >= 0], 1), -c)
    coo.add(p, vgid(left, 0), c)
    coo.add(p, vgid(lower, 1), c)
    return coo.tocsr(n)


def darcy3d(nx, ny, nz, a=1.0, b=-1.0, perio=NO_PERIO) -> sp.csr_matrix:
    """3D C-grid Darcy, dof=4 (u,v,w,p); reference GaleriExt_Darcy3D.h."""
    dof = 4
    n = nx * ny * nz * dof
    left, right, lower, upper, below, above = _neighbors3d(nx, ny, nz, perio)
    base = np.arange(nx * ny * nz)
    c = -b
    coo = _Coo()

    def vgid(node, var):
        return np.where(np.asarray(node) >= 0, np.asarray(node) * dof + var, -1)

    for var, nb in ((0, right), (1, upper), (2, above)):
        r = base * dof + var
        coo.add(r, r, a)
        m = nb >= 0
        coo.add(r[m], vgid(base[m], dof - 1), -b)
        coo.add(r[m], vgid(nb[m], dof - 1), b)
    p = base * dof + (dof - 1)
    for var, nb_plus, nb_minus in ((0, right, left), (1, upper, lower),
                                   (2, above, below)):
        m = nb_plus >= 0
        coo.add(p[m], vgid(base[m], var), -c)
        coo.add(p, vgid(nb_minus, var), c)
    return coo.tocsr(n)


def darcyb2d(nx, ny, a=1.0, b=-1.0, perio=NO_PERIO) -> sp.csr_matrix:
    """2D B-grid Darcy (velocities at cell corners): each velocity
    couples to the 4 surrounding pressures; reference
    GaleriExt_Darcy2D.h:157-303 (DarcyB2D)."""
    dof = 3
    n = nx * ny * dof
    left, right, lower, upper = _neighbors2d(nx, ny, perio)
    base = np.arange(nx * ny)
    c = -b
    coo = _Coo()

    def pg(node):
        return np.where(np.asarray(node) >= 0,
                        np.asarray(node) * dof + 2, -1)

    top_right = np.where(upper >= 0, right[np.clip(upper, 0, None)], -1)
    top_right = np.where((upper >= 0) & (right >= 0), top_right, -1)
    bottom_left = np.where(lower >= 0, left[np.clip(lower, 0, None)], -1)
    bottom_left = np.where((lower >= 0) & (left >= 0), bottom_left, -1)

    m_ru = (right >= 0) & (upper >= 0)
    for var, signs in ((0, (-b, b, -b, b)), (1, (-b, -b, b, b))):
        r = base * dof + var
        coo.add(r, r, a)
        coo.add(r[m_ru], pg(base[m_ru]), signs[0])
        coo.add(r[m_ru], pg(right[m_ru]), signs[1])
        coo.add(r[m_ru], pg(upper[m_ru]), signs[2])
        coo.add(r[m_ru], pg(top_right[m_ru]), signs[3])

    # divergence rows (reference DarcyB2D P-branch)
    p = base * dof + 2

    def vg(node, var):
        return np.where(np.asarray(node) >= 0,
                        np.asarray(node) * dof + var, -1)

    m = (right >= 0) & (upper >= 0)
    coo.add(p[m], vg(base[m], 0), -c)
    coo.add(p[m], vg(base[m], 1), -c)
    m = (left >= 0) & (upper >= 0)
    coo.add(p[m], vg(left[m], 0), c)
    coo.add(p[m], vg(left[m], 1), -c)
    m = (lower >= 0) & (right >= 0)
    coo.add(p[m], vg(lower[m], 0), -c)
    coo.add(p[m], vg(lower[m], 1), c)
    m = (lower >= 0) & (left >= 0)
    coo.add(p[m], vg(bottom_left[m], 0), c)
    coo.add(p[m], vg(bottom_left[m], 1), c)
    return coo.tocsr(n)


def stokes2d_b(nx, ny, a=None, b=1.0, perio=NO_PERIO) -> sp.csr_matrix:
    """2D B-grid Stokes (grid_type='B' in the reference Stokes2D):
    corner velocities with full 5-point Laplacians; both u and v are
    Dirichlet on the right AND top walls (staggering CENTERED_NONE:
    both wall branches fire for every velocity,
    GaleriExt_Stokes2D.h:104-214)."""
    if a is None:
        a = float(nx * nx)
    dof = 3
    n = nx * ny * dof
    base = np.arange(nx * ny)
    left, right, lower, upper = _neighbors2d(nx, ny, perio)
    lleft, lright, llower, lupper = _neighbors2d(nx, ny, NO_PERIO)
    neumann = perio != NO_PERIO

    def second_of(nb, table):
        out = np.full(base.shape, -1)
        m = nb > 0
        out[m] = table[nb[m]]
        return out

    rightright = second_of(right, right)
    upup = second_of(upper, upper)

    coo = _Coo()
    darcy = darcyb2d(nx, ny, 0.0, -b, perio)
    lap_nbs = (lleft, lright, llower, lupper)

    for ivar in (0, 1):
        rows = base * dof + ivar
        dir_mask = (right < 0) | (upper < 0)

        lap_diag = np.full(base.shape, 4.0)
        if neumann:
            for nb in lap_nbs:
                lap_diag += np.where(nb < 0, -1.0, 0.0)

        diag_val = np.where(dir_mask, -(b / (a * a)) * a, -(lap_diag * a))
        coo.add(rows, rows, diag_val)

        zero_r = np.where((right > 0) & (rightright < 0), right, -1)
        zero_u = np.where((upper > 0) & (upup < 0), upper, -1)
        for nb in lap_nbs:
            v = np.where(((nb >= 0) & (nb == zero_r))
                         | ((nb >= 0) & (nb == zero_u)), 0.0, a)
            keep = (nb >= 0) & ~dir_mask
            coo.add(rows[keep], nb[keep] * dof + ivar, v[keep])

    A_lap = coo.tocsr(n)
    K = (A_lap + darcy).tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K


def stokes2d(nx, ny, a=None, b=1.0, perio=NO_PERIO) -> sp.csr_matrix:
    """2D C-grid Stokes K=[A B; B' 0], dof=3; A = -a*Laplace(u/v) with
    staggered boundary fixes.  Matches reference
    src/GaleriExt_Stokes2D.h:88-218 (a = nx*nx, b = 1 per
    HYMLS_MainUtils.cpp:315-316).  When periodic, the reference swaps
    the velocity Laplace for the Neumann variant without wrap
    (GaleriExt_Stokes2D.h:78-82)."""
    if a is None:
        a = float(nx * nx)
    dof = 3
    n = nx * ny * dof
    base = np.arange(nx * ny)
    # perio-aware neighbors drive the staggered boundary logic
    left, right, lower, upper = _neighbors2d(nx, ny, perio)
    # the Laplace stencil itself never wraps; Neumann folding if periodic
    lleft, lright, llower, lupper = _neighbors2d(nx, ny, NO_PERIO)
    neumann = perio != NO_PERIO

    def second_of(nb, table):
        out = np.full(base.shape, -1)
        m = nb > 0
        out[m] = table[nb[m]]
        return out

    coo = _Coo()
    darcy = darcy2d(nx, ny, 0.0, -b, perio)

    specs = (
        # (ivar, dir-neighbor, its second, tangential pair)
        (0, right, second_of(right, right), (lower, upper)),
        (1, upper, second_of(upper, upper), (left, right)),
    )
    lap_nbs = (lleft, lright, llower, lupper)
    for ivar, dirn, second, tang in specs:
        rows = base * dof + ivar
        dir_mask = dirn < 0

        lap_diag = np.full(base.shape, 4.0)
        if neumann:
            for nb in lap_nbs:
                lap_diag += np.where(nb < 0, -1.0, 0.0)

        # u is centered in y / v centered in x: missing tangential
        # neighbor adds +a to the diagonal (GaleriExt_Stokes2D.h:158,179)
        add_to_diag = np.where((tang[0] < 0) | (tang[1] < 0), a, 0.0)
        add_to_diag = np.where(dir_mask, 0.0, add_to_diag)

        # Dirichlet rows (velocity on the closed wall): single diagonal
        # entry b/(a*a), scaled by -a below => -b/a
        diag_val = np.where(dir_mask, -(b / (a * a)) * a,
                            -(lap_diag * a + add_to_diag))
        coo.add(rows, rows, diag_val)

        # remove couplings to the Dirichlet velocity layer
        zero_to = np.where((dirn > 0) & (second < 0), dirn, -1)
        for nb in lap_nbs:
            v = np.where((nb >= 0) & (nb == zero_to), 0.0, a)  # -(-1)*a
            keep = (nb >= 0) & ~dir_mask
            coo.add(rows[keep], nb[keep] * dof + ivar, v[keep])

    A_lap = coo.tocsr(n)
    K = (A_lap + darcy).tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K


def darcy_thcm3d(nx, ny, nz, a=1.0, b=-1.0, perio=NO_PERIO) -> sp.csr_matrix:
    """3D THCM/L-grid Darcy: u,v at cell corners in the xy plane (4
    pressure couplings), w staggered in z (2 pressures); reference
    GaleriExt_Darcy3D.h:446-614 (DarcyTHCM3D)."""
    dof = 4
    n = nx * ny * nz * dof
    left, right, lower, upper, below, above = _neighbors3d(nx, ny, nz, perio)
    base = np.arange(nx * ny * nz)
    c = -b
    coo = _Coo()

    def second2(nb1, nb2):
        """nb2-neighbor of nb1 (e.g. upper_right)."""
        out = np.full(base.shape, -1)
        m = nb1 >= 0
        out[m] = nb2[nb1[m]]
        return out

    upper_right = second2(upper, right)
    upper_left = second2(upper, left)
    lower_right = second2(lower, right)
    lower_left = second2(lower, left)

    def pg(node):
        return np.where(np.asarray(node) >= 0,
                        np.asarray(node) * dof + 3, -1)

    def vg(node, var):
        return np.where(np.asarray(node) >= 0,
                        np.asarray(node) * dof + var, -1)

    m_ur = upper_right >= 0
    for var, signs in ((0, (-b, -b, b, b)), (1, (-b, b, -b, b))):
        r = base * dof + var
        coo.add(r, r, a)
        coo.add(r[m_ur], pg(base[m_ur]), signs[0])
        coo.add(r[m_ur], pg(upper[m_ur]), signs[1])
        coo.add(r[m_ur], pg(right[m_ur]), signs[2])
        coo.add(r[m_ur], pg(upper_right[m_ur]), signs[3])
    w = base * dof + 2
    coo.add(w, w, a)
    mw = above >= 0
    coo.add(w[mw], pg(base[mw]), -b)
    coo.add(w[mw], pg(above[mw]), b)

    # divergence rows
    p = base * dof + 3
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


def stokes3d(nx, ny, nz, a=None, b=1.0, perio=NO_PERIO,
             grid_type="C") -> sp.csr_matrix:
    """3D Stokes on the C / L / T(HCM) grids, dof=4; reference
    src/GaleriExt_Stokes3D.h.

    Staggering flags per grid type (GaleriExt_Stokes3D.h:155-175):
      C: u centered in y,z; v in x,z; w in x,y.
      L/T: u,v centered in z (corner velocities in the xy plane);
           w centered in x,y.  'T' additionally zeroes the w Laplace
           block (hydrostatic balance) and adds Coriolis u/v coupling.
    Dirichlet velocity rows use -1/a (scaled by -a => diagonal +1)."""
    if a is None:
        a = float(nx * nx)
    dof = 4
    n = nx * ny * nz * dof
    base = np.arange(nx * ny * nz)
    left, right, lower, upper, below, above = _neighbors3d(nx, ny, nz, perio)
    lnbs = _neighbors3d(nx, ny, nz, NO_PERIO)
    neumann = perio != NO_PERIO

    def second_of(nb, table):
        out = np.full(base.shape, -1)
        m = nb > 0
        out[m] = table[nb[m]]
        return out

    CENTERED_X, CENTERED_Y, CENTERED_Z = 1, 2, 4

    coo = _Coo()
    if grid_type == "C":
        darcy = darcy3d(nx, ny, nz, 0.0, -b, perio)
        staggering = ((CENTERED_Y | CENTERED_Z),
                      (CENTERED_X | CENTERED_Z),
                      (CENTERED_X | CENTERED_Y))
    else:
        darcy = darcy_thcm3d(nx, ny, nz, 0.0, -b, perio)
        # u,v: CENTERED_Z (xy-corner velocities); w: CENTERED_X|_Y
        staggering = (CENTERED_Z, CENTERED_Z, CENTERED_X | CENTERED_Y)

    # the three boundary branches of the reference assembly
    # (GaleriExt_Stokes3D.h:190-255): each runs when its centered-bit
    # is UNSET; `trigger` makes the row Dirichlet; the compensation
    # pairs add +a for the tangential directions whose bit IS set;
    # `second` is the neighbour-of-neighbour used to cut the coupling
    # to boundary velocities.
    branches = (
        (CENTERED_X, right, second_of(right, right),
         ((lower, upper, CENTERED_Y), (below, above, CENTERED_Z))),
        (CENTERED_Y, upper, second_of(upper, upper),
         ((left, right, CENTERED_X), (below, above, CENTERED_Z))),
        (CENTERED_Z, above, second_of(above, above),
         ((left, right, CENTERED_X), (lower, upper, CENTERED_Y))),
    )

    omega = 100.0
    for ivar in range(3):
        stag = staggering[ivar]
        rows = base * dof + ivar
        thcm_w = grid_type == "T" and ivar == 2

        lap_diag = np.full(base.shape, 6.0)
        if neumann:
            for nb in lnbs:
                lap_diag += np.where(nb < 0, -1.0, 0.0)
        if thcm_w:
            lap_diag = np.zeros(base.shape)

        dir_mask = np.zeros(base.shape, dtype=bool)
        add_to_diag = np.zeros(base.shape)
        zero_tos = []
        for bit, trigger, second, comps in branches:
            if stag & bit:
                continue
            own_dir = trigger < 0
            dir_mask |= own_dir
            # add_to_diag accumulates independently of OTHER branches'
            # Dirichlet resets (reference keeps a running add_to_diag)
            for t0, t1, cbit in comps:
                if stag & cbit:
                    add_to_diag += np.where(
                        ~own_dir & ((t0 < 0) | (t1 < 0)), a, 0.0)
            zero_tos.append(np.where((trigger > 0) & (second < 0),
                                     trigger, -1))
        if thcm_w:
            add_to_diag = np.zeros(base.shape)

        # Dirichlet rows: -(-1/a * a + add) = 1 - add (the reference
        # keeps the accumulated compensation on Dirichlet diagonals)
        diag_val = np.where(dir_mask, 1.0 - add_to_diag,
                            -(lap_diag * a + add_to_diag))
        coo.add(rows, rows, diag_val)

        if not thcm_w:
            for nb in lnbs:
                v = np.full(base.shape, a)
                for zt in zero_tos:
                    v = np.where((nb >= 0) & (nb == zt), 0.0, v)
                keep = (nb >= 0) & ~dir_mask
                coo.add(rows[keep], nb[keep] * dof + ivar, v[keep])

        # Coriolis coupling on the THCM grid (u <-> v), wiped on
        # Dirichlet rows
        if grid_type == "T" and ivar == 0:
            coo.add(rows[~dir_mask], rows[~dir_mask] + 1, -omega * a)
        elif grid_type == "T" and ivar == 1:
            coo.add(rows[~dir_mask], rows[~dir_mask] - 1, omega * a)

    A_lap = coo.tocsr(n)
    K = (A_lap + darcy).tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K


# ---------------------------------------------------------------------------
# Driver-level helpers (reference HYMLS_MainUtils.cpp)
# ---------------------------------------------------------------------------

def create_matrix(params: Params) -> sp.csr_matrix:
    """Build the operator selected by the 'Problem' sublist (and the
    optional Driver 'Galeri Label'); reference
    HYMLS_MainUtils.cpp:260-348."""
    prob = params.sublist("Problem")
    eqn = prob.get("Equations", "Laplace")
    dim = prob.get("Dimension", 2)
    nx = prob.get("nx", 32)
    ny = prob.get("ny", nx)
    nz = prob.get("nz", nx if dim > 2 else 1)
    perio = NO_PERIO
    if prob.get("x-periodic", False):
        perio |= X_PERIO
    if prob.get("y-periodic", False):
        perio |= Y_PERIO
    if prob.get("z-periodic", False):
        perio |= Z_PERIO

    label = params.sublist("Driver").get("Galeri Label", "")
    if label == "Stretched2D":
        eps = params.sublist("Driver").sublist("Galeri").get(
            "epsilon", prob.get("epsilon", 0.1))
        return stretched2d(nx, ny, eps)
    if label == "UniFlow2D":
        g = params.sublist("Driver").sublist("Galeri")
        return uniflow2d(nx, ny, conv=g.get("conv", 1.0),
                         diff=g.get("diff", 1.0),
                         alpha=g.get("alpha", 0.0), perio=perio)
    if label == "Laplace Neumann":
        A = laplace2d_neumann(nx, ny) if dim == 2 else \
            laplace3d_neumann(nx, ny, nz)
        return A
    if label == "Darcy":
        return darcy2d(nx, ny, 1.0, -1.0, perio) if dim == 2 else \
            darcy3d(nx, ny, nz, 1.0, -1.0, perio)

    if eqn == "Laplace":
        return laplace2d(nx, ny, perio) if dim == 2 else \
            laplace3d(nx, ny, nz, perio)
    if eqn == "Darcy":
        return darcy2d(nx, ny, 1.0, -1.0, perio) if dim == 2 else \
            darcy3d(nx, ny, nz, 1.0, -1.0, perio)
    if eqn == "Stokes-C":
        return stokes2d(nx, ny, float(nx * nx), 1.0, perio) if dim == 2 \
            else stokes3d(nx, ny, nz, float(nx * nx), 1.0, perio)
    # the grid type comes from the Galeri Label's last letter when set
    # (reference HYMLS_MainUtils.cpp:308-324), else from 'Equations'
    gt = label[-1] if label.startswith("Stokes-") else (
        eqn[-1] if eqn.startswith("Stokes-") else "")
    if gt == "B" and dim == 2:
        return stokes2d_b(nx, ny, float(nx * nx), 1.0, perio)
    if gt in ("L", "T") and dim == 2:
        # parity with the reference: 2D supports only C/B grids —
        # GaleriExt::Matrices::Darcy2D throws "Unknown grid type" for
        # L/T (reference src/GaleriExt_Darcy2D.h:315-320); L/T grids
        # exist in 3D only
        raise ValueError(
            f"2D Stokes grid type '{gt}' is not defined (the reference "
            "supports C/B in 2D and C/B/L/T in 3D)")
    if gt in ("L", "T", "B") and dim == 3:
        return stokes3d(nx, ny, nz, float(nx * nx), 1.0, perio,
                        "L" if gt == "B" else gt)
    raise ValueError(f"Equations '{eqn}' not supported by create_matrix")


def create_testvector(params: Params, K: sp.csr_matrix) -> np.ndarray:
    """Ones test vector (checkerboard for B-grids), zeroed on rows whose
    only nonzero is the diagonal (Dirichlet rows); reference
    HYMLS_MainUtils.cpp:208-258."""
    prob = params.sublist("Problem")
    eqn = prob.get("Equations", "Laplace")
    n = K.shape[0]
    tv = np.ones(n)

    if eqn in ("Stokes-B", "Stokes-L", "Stokes-T"):
        nx = prob.get("nx", 32)
        ny = prob.get("ny", nx)
        dim = prob.get("Dimension", -1)
        dof = prob.get("Degrees of Freedom", -1)
        gid = np.arange(n)
        node = gid // dof
        var = gid % dof
        tv = np.where(var == 0, ((node % nx) % 2) * 2.0 - 1.0, tv)
        tv = np.where(var == 1, (((node // nx) % ny) % 2) * 2.0 - 1.0, tv)
        if dim > 2 and eqn == "Stokes-B":
            tv = np.where(var == 2,
                          (((node // nx) // ny) % 2) * 2.0 - 1.0, tv)

    # zero out rows that couple only to themselves
    Koff = K.copy()
    Koff.setdiag(0.0)
    Koff.eliminate_zeros()
    offdiag_count = np.diff(Koff.indptr)
    # also treat rows whose off-diagonal entries are stored zeros
    tv[offdiag_count == 0] = 0.0
    return tv


def create_nullspace(params: Params, n: int) -> np.ndarray:
    """Nullspace vectors (normalized columns); reference
    HYMLS_MainUtils.cpp:350-441."""
    from ..grid import grid_from_params
    grid = grid_from_params(params)
    prob = params.sublist("Problem")
    dim = grid.dim
    dof = grid.dof
    eqn = prob.get("Equations", "Laplace")
    kind = params.sublist("Driver").get("Null Space Type", "None")
    if kind == "None":
        return None
    gid = np.arange(n)
    if kind == "Constant":
        ns = np.zeros((n, dof))
        for d in range(dof):
            ns[gid % dof == d, d] = 1.0
    elif kind == "Constant P":
        pvar = prob.get("Pressure Variable", dim)
        ns = np.zeros((n, 1))
        ns[gid % dof == pvar, 0] = 1.0
    elif kind == "Checkerboard":
        pvar = prob.get("Pressure Variable", dim)
        nx = prob.get("nx", 1)
        ny = prob.get("ny", nx)
        stokes_b = 1 if eqn == "Stokes-B" else 0
        node = gid // dof
        i = node % nx
        j = (node // nx) % ny
        k = node // (nx * ny)
        val1 = ((i + j + k * stokes_b) % 2).astype(float)
        ns = np.zeros((n, 2))
        pm = gid % dof == pvar
        ns[pm, 0] = val1[pm]
        ns[pm, 1] = 1.0 - val1[pm]
    else:
        raise ValueError(f"Null Space Type '{kind}' not implemented")
    ns /= np.linalg.norm(ns, axis=0, keepdims=True)
    return ns
