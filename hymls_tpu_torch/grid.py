"""Structured-grid index math and per-dof variable typing.

Mirrors the semantics of the reference's Tools::ind2sub/sub2ind
(reference src/HYMLS_Tools.hpp:57-68) and the variable-type resolution
in BasePartitioner::SetParameters (reference
src/HYMLS_BasePartitioner.cpp:143-318): node gid = d + i*dof +
j*nx*dof + k*nx*ny*dof.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from .config import Params


class VarType(enum.IntEnum):
    VELOCITY_U = 0
    VELOCITY_V = 1
    VELOCITY_W = 2
    PRESSURE = 3
    INTERIOR = 4


# Periodicity flags (bitmask like the reference GaleriExt::PERIO_Flag)
NO_PERIO = 0
X_PERIO = 1
Y_PERIO = 2
Z_PERIO = 4


@dataclass
class GridInfo:
    """Static description of the structured grid and its dof layout."""

    nx: int
    ny: int
    nz: int
    dof: int
    dim: int
    var_types: List[VarType]
    perio: int = NO_PERIO
    pvar: int = -1  # index of the pressure variable, or -1

    @property
    def num_nodes(self) -> int:
        return self.nx * self.ny * self.nz * self.dof

    def sub2ind(self, i, j, k, d):
        """(i,j,k,var) -> gid; accepts arrays."""
        nx, ny, dof = self.nx, self.ny, self.dof
        return d + dof * (np.asarray(i) + nx * (np.asarray(j) + ny * np.asarray(k)))

    def ind2sub(self, gid):
        """gid -> (i,j,k,var); accepts arrays."""
        gid = np.asarray(gid)
        nx, ny, dof = self.nx, self.ny, self.dof
        d = gid % dof
        node = gid // dof
        i = node % nx
        j = (node // nx) % ny
        k = node // (nx * ny)
        return i, j, k, d


def grid_from_params(params: Params) -> GridInfo:
    """Resolve grid shape, dof count, and per-dof variable types from the
    'Problem' sublist, with the same defaulting rules as the reference
    (src/HYMLS_BasePartitioner.cpp:31-318)."""
    prob = params.sublist("Problem")
    dim = prob.get("Dimension", 3)
    nx = prob.get("nx", -1)
    if nx == -1:
        raise ValueError("'nx' must be set in the 'Problem' sublist")
    ny = prob.get("ny", nx)
    nz = prob.get("nz", nx if dim > 2 else 1)

    perio = NO_PERIO
    if prob.get("x-periodic", False):
        perio |= X_PERIO
    if dim > 1 and prob.get("y-periodic", False):
        perio |= Y_PERIO
    if dim > 2 and prob.get("z-periodic", False):
        perio |= Z_PERIO
    perio = prob.get("Periodicity", perio)

    pvar = -1
    eqn = prob.get("Equations", None)
    if eqn is not None:
        if eqn == "Laplace":
            prob.get("Degrees of Freedom", 1)
            prob.sublist("Variable 0").get("Variable Type", "Laplace")
        elif eqn.startswith("Stokes") or eqn in ("Bous-C", "Darcy"):
            if eqn == "Bous-C":
                prob.get("Degrees of Freedom", dim + 2)
                pvar = prob.get("Pressure Variable", dim + 1)
            else:
                prob.get("Degrees of Freedom", dim + 1)
                pvar = prob.get("Pressure Variable", dim)
            dof = prob.get("Degrees of Freedom", 1)
            for i in range(dim):
                prob.sublist(f"Variable {i}").get("Variable Type", "Velocity")
            prob.sublist(f"Variable {pvar}").get("Variable Type", "Pressure")
            for i in range(dof):
                prob.sublist(f"Variable {i}").get("Variable Type", "Laplace")
            if eqn in ("Stokes-B", "Stokes-L", "Stokes-T"):
                prob.get("Retained Pressure Nodes", 2)
                if params.sublist("Preconditioner").get("Fix Pressure Level", True):
                    params.sublist("Preconditioner").get("Fix GID 1", pvar)
                    params.sublist("Preconditioner").get("Fix GID 2", dof + pvar)
            else:
                if params.sublist("Preconditioner").get("Fix Pressure Level", True):
                    params.sublist("Preconditioner").get("Fix GID 1", pvar)
                prob.get("Retained Pressure Nodes", 1)
        else:
            raise ValueError(f"'Equations'='{eqn}' not recognized")

    dof = prob.get("Degrees of Freedom", None)
    if dof is None:
        raise ValueError("'Problem' list must contain 'Degrees of Freedom' "
                         "(or an 'Equations' entry that implies it)")

    var_types: List[VarType] = []
    vcount = 0
    for i in range(dof):
        vt = prob.sublist(f"Variable {i}").get("Variable Type", "Laplace")
        if vt == "Laplace":
            # the reference classifies Laplace variables like V-velocities
            # (src/HYMLS_BasePartitioner.cpp:274-275)
            var_types.append(VarType.VELOCITY_V)
        elif vt == "Velocity U" or (vt == "Velocity" and vcount == 0):
            var_types.append(VarType.VELOCITY_U)
            vcount += 1
        elif vt == "Velocity V" or (vt == "Velocity" and vcount == 1):
            var_types.append(VarType.VELOCITY_V)
            vcount += 1
        elif vt == "Velocity W" or (vt == "Velocity" and vcount == 2):
            var_types.append(VarType.VELOCITY_W)
            vcount += 1
        elif vt == "Pressure":
            pvar = i
            var_types.append(VarType.PRESSURE)
        elif vt == "Interior":
            var_types.append(VarType.INTERIOR)
        else:
            raise ValueError(f"Variable type '{vt}' does not exist")

    pvar = prob.get("Pressure Variable", pvar)

    return GridInfo(nx=nx, ny=ny, nz=nz, dof=dof, dim=dim,
                    var_types=var_types, perio=perio, pvar=pvar)
