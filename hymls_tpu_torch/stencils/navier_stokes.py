"""Linearized Navier-Stokes (driven-cavity) Jacobians on the C-grid.

The reference's headline benchmark solves lid-driven cavity Jacobians
at Re 0/100/1000 read from data files produced by an external
continuation code (reference testSuite/cavity.xml,
testSuite/data/DrivenCavity/*).  This module generates equivalent
operators self-contained: the Stokes C-grid operator (stencils
.generators.stokes2d, matching GaleriExt) plus the linearization of the
convective term (U0.grad)u + (u.grad)U0 around a smooth cavity-vortex
base flow, central-differenced on the staggered grid.

The resulting K(Re) = [A(U0) G; D 0] keeps the F-matrix structure (the
gradient/divergence blocks are untouched), is nonsymmetric and
convection-dominated at high Re — the regime the multilevel method is
designed not to break down in.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .generators import stokes2d, _Coo
from ..grid import NO_PERIO


def _psi_derivs(x, y):
    """Streamfunction psi = 16 x^2(1-x)^2 y^2(1-y)^2 (regularized
    cavity vortex, psi=0 and grad psi=0 on the walls) and its
    derivatives: u0 = dpsi/dy, v0 = -dpsi/dx."""
    fx = x * x * (1 - x) ** 2
    fy = y * y * (1 - y) ** 2
    dfx = 2 * x * (1 - x) * (1 - 2 * x)
    dfy = 2 * y * (1 - y) * (1 - 2 * y)
    d2fx = 2 * (1 - 6 * x + 6 * x * x)
    d2fy = 2 * (1 - 6 * y + 6 * y * y)
    u0 = 16 * fx * dfy
    v0 = -16 * dfx * fy
    du0dx = 16 * dfx * dfy
    du0dy = 16 * fx * d2fy
    dv0dx = -16 * d2fx * fy
    dv0dy = -16 * dfx * dfy
    return u0, v0, du0dx, du0dy, dv0dx, dv0dy


def cavity_jacobian(nx: int, ny: int, re: float = 0.0,
                    a: float = None, b: float = 1.0) -> sp.csr_matrix:
    """K(Re): Stokes operator + Re-scaled linearized convection.

    With the reference's viscous scaling a = nx^2, the convection terms
    carry a factor Re*nx (one grid derivative), giving cell Peclet
    number ~ Re/(2 nx)."""
    if a is None:
        a = float(nx * nx)
    K = stokes2d(nx, ny, a, b, NO_PERIO)
    if re == 0.0:
        return K

    dof = 3
    h = 1.0 / nx
    base = np.arange(nx * ny)
    ix = base % nx
    iy = base // nx

    coo = _Coo()

    def gid(i, j, d):
        """Velocity gid with boundary masking: -1 outside or on a
        Dirichlet wall (u at i=nx-1, v at j=ny-1)."""
        i = np.asarray(i)
        j = np.asarray(j)
        ok = (i >= 0) & (i < nx) & (j >= 0) & (j < ny)
        if d == 0:
            ok &= i < nx - 1
        else:
            ok &= j < ny - 1
        return np.where(ok, (i + nx * j) * dof + d, -1)

    c = re * nx  # one grid derivative
    scale = 1.0  # overall convection scale

    # --- u-momentum rows (u(i,j) at ((i+1)h, (j+1/2)h)) -----------------
    xu = (ix + 1.0) * h
    yu = (iy + 0.5) * h
    u0, v0, du0dx, du0dy, _, _ = _psi_derivs(xu, yu)
    rows_u = base * dof + 0
    live_u = ix < nx - 1   # u on the right wall is a Dirichlet row
    r = rows_u[live_u]

    def addu(cols, vals):
        m = live_u & (cols >= 0)
        coo.add(rows_u[m], cols[m], vals[m])

    addu(gid(ix + 1, iy, 0), scale * c * u0 / 2)
    addu(gid(ix - 1, iy, 0), -scale * c * u0 / 2)
    addu(gid(ix, iy + 1, 0), scale * c * v0 / 2)
    addu(gid(ix, iy - 1, 0), -scale * c * v0 / 2)
    addu(gid(ix, iy, 0), scale * re * du0dx)
    for (di, dj) in ((0, 0), (1, 0), (0, -1), (1, -1)):
        addu(gid(ix + di, iy + dj, 1), scale * re * du0dy / 4)

    # --- v-momentum rows (v(i,j) at ((i+1/2)h, (j+1)h)) -----------------
    xv = (ix + 0.5) * h
    yv = (iy + 1.0) * h
    u0v, v0v, _, _, dv0dx, dv0dy = _psi_derivs(xv, yv)
    rows_v = base * dof + 1
    live_v = iy < ny - 1

    def addv(cols, vals):
        m = live_v & (cols >= 0)
        coo.add(rows_v[m], cols[m], vals[m])

    addv(gid(ix + 1, iy, 1), scale * c * u0v / 2)
    addv(gid(ix - 1, iy, 1), -scale * c * u0v / 2)
    addv(gid(ix, iy + 1, 1), scale * c * v0v / 2)
    addv(gid(ix, iy - 1, 1), -scale * c * v0v / 2)
    addv(gid(ix, iy, 1), scale * re * dv0dy)
    for (di, dj) in ((0, 0), (-1, 0), (0, 1), (-1, 1)):
        addv(gid(ix + di, iy + dj, 0), scale * re * dv0dx / 4)

    C = coo.tocsr(K.shape[0])
    K = (K + C).tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K
