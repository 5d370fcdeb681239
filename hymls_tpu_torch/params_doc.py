"""Valid-parameter catalog, documentation and validation.

The reference documents every accepted parameter per class through
Teuchos valid-parameter lists (reference src/HYMLS_Preconditioner.cpp:
135-276, src/HYMLS_PLA.hpp:14-22) and dumps the documentation from the
driver (reference src/main.cpp:502-508, printValidParameters).  This
module is the equivalent: one catalog of every parameter the framework
reads, used for `--params-doc` output and for unknown-parameter
warnings ("Validate Parameter Lists" role).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .config import Params

# sublist -> name -> (type, default, doc)
CATALOG: Dict[str, Dict[str, Tuple[str, object, str]]] = {
    "Problem": {
        "Equations": ("string", "Laplace",
                      "Operator family: Laplace | Laplace Neumann | "
                      "Darcy | Stokes-C | Stokes-B | Stokes-L | "
                      "Stokes-T(HCM) | Star3D | Stretched2D | ..."),
        "Dimension": ("int", 3, "Spatial dimension (2 or 3)"),
        "nx": ("int", -1, "Grid cells in x"),
        "ny": ("int", -1, "Grid cells in y (default nx)"),
        "nz": ("int", -1, "Grid cells in z (default nx for 3D)"),
        "Degrees of Freedom": ("int", 1,
                               "Unknowns per grid cell (derived from "
                               "Equations when omitted)"),
        "x-periodic": ("bool", False, "Periodic in x"),
        "y-periodic": ("bool", False, "Periodic in y"),
        "z-periodic": ("bool", False, "Periodic in z"),
        "Periodicity": ("int", 0, "Explicit periodicity bitmask"),
        "Pressure Variable": ("int", -1,
                              "Index of the pressure dof (derived from "
                              "variable types when omitted)"),
        "Galeri Label": ("string", "", "Explicit generator label"),
        "Read Linear System": ("bool", False,
                               "Load matrix/rhs/sol from Data Directory "
                               "instead of generating"),
        "Data Directory": ("string", "", "Reference-layout data dir"),
        "alpha": ("double", 1.0, "Generator coefficient (Darcy a)"),
        "epsilon": ("double", 1.0, "Stretching factor (Stretched2D)"),
        "conv": ("double", 1.0, "Convection coefficient (convdiff)"),
        "diff": ("double", 1.0, "Diffusion coefficient (convdiff)"),
        "Variable <i>": ("sublist", None,
                         "Per-dof variable spec: 'Variable Type' in "
                         "{Velocity U/V/W, Pressure, Laplace, Interior}"),
    },
    "Solver": {
        "Krylov Method": ("string", "GMRES", "GMRES | CG"),
        "Initial Vector": ("string", "Zero", "Zero | Random | Previous"),
        "Left or Right Preconditioning": ("string", "Left",
                                          "Preconditioning side"),
        "Use Deflation": ("bool", False,
                          "Deflate dominant eigenmodes of P^-1 M"),
        "Use Bordering": ("bool", False,
                          "Solve the bordered system [K V; W' C]"),
        "Complex": ("bool", False,
                    "Complex pair solves (A + iB) with the real "
                    "preconditioner"),
        "Deflation Threshold": ("double", 0.0,
                                "Keep deflation eigenvalues above this "
                                "magnitude"),
        "Deflated Subspace Dimension": ("int", 0,
                                        "Number of deflation vectors"),
        "Iterative Solver": ("sublist", None,
                             "Maximum Iterations (int, 100), "
                             "Convergence Tolerance (double, 1e-6), "
                             "Num Blocks (int; GMRES restart length), "
                             "Inner Maximum Iterations (int, 64; cap "
                             "on the f32 inner Krylov basis in the "
                             "iterative-refinement solver)"),
    },
    "Preconditioner": {
        "Partitioner": ("string", "Cartesian",
                        "Cartesian | Skew Cartesian"),
        "Separator Length": ("int", 4,
                             "Subdomain size sx (per-direction "
                             "overrides: 'Separator Length (x|y|z)')"),
        "Coarsening Factor": ("int", 0,
                              "Next-level growth cx (default sx; "
                              "per-direction overrides available)"),
        "Number of Levels": ("int", 1,
                             "Multilevel depth; 0 = direct Schur solve"),
        "Retain Nodes": ("int", 1,
                         "Vsum nodes kept per separator group "
                         "(per-level: 'Retain Nodes at Level <k>')"),
        "Retained Pressure Nodes": ("int", 1,
                                    "Pressure nodes kept per subdomain"),
        "Fix Pressure Level": ("bool", True,
                               "Pin a pressure at the coarsest level"),
        "Fix GID 1": ("int", -1, "Explicit pinned GID"),
        "Fix GID 2": ("int", -1, "Second pinned GID"),
        "Preconditioner Variant": ("string", "Block Diagonal",
                                   "Block Diagonal | Lower Triangular | "
                                   "Upper Triangular | Domain "
                                   "Decomposition | Do Nothing"),
        "Apply Dropping": ("bool", True,
                           "Drop non-Vsum couplings after the "
                           "orthogonal transform"),
        "B-Grid Transform": ("bool", False,
                             "Givens pre-transform for B-grid problems"),
        "Use 64-bit Indices": ("bool", False,
                               "Force int64 device plan indices (the "
                               "reference's HYMLS_LONG_LONG build "
                               "option); otherwise plans auto-promote "
                               "when a flat index exceeds int32 range"),
        "Eliminate Velocities Together": ("bool", False,
                                          "B-grid velocity pairing"),
        "Structured Apply": ("string", "Auto",
                             "'Auto' | true | false.  true forces the "
                             "gather-free structured V-cycle (error if "
                             "the partition doesn't allow it), false "
                             "disables it, 'Auto' enables it when the "
                             "partition allows it AND the problem is "
                             "large enough for the fold matmuls to win "
                             "(size heuristic)"),
        "Factor Precision": ("string", "Same",
                             "'Same' | 'f64'.  'f64' assembles the "
                             "multilevel factors in f64 and casts them "
                             "to the apply dtype — required for f32 "
                             "applies of multilevel (L>=2) problems "
                             "where f32 Schur-assembly cancellation "
                             "destroys the preconditioner; the "
                             "IterativeRefinementSolver defaults to "
                             "'f64' when Number of Levels >= 2 and "
                             "'Same' otherwise (single-level assembly "
                             "has no recursive cancellation chain; "
                             "setup-only cost)"),
        "Schur Assembly": ("string", "Full f64",
                           "'Full f64' | 'Vsum f64' (factor-upcast "
                           "mode only).  'Vsum f64' restricts the "
                           "emulated-f64 matmul chain to the "
                           "next-level (Vsum) entries.  EXPERIMENTAL: "
                           "wins only when nv << ns and the non-Vsum "
                           "blocks tolerate f32 assembly (Cartesian "
                           "L=2 holds parity in tests; the skew "
                           "cavity128 flagship regressed both time "
                           "and iterations on v5e, so the default "
                           "stays 'Full f64')"),
        "Drop Tolerance": ("double", 1e-14, "Small-entry drop threshold"),
        "Fill Factor": ("double", 3.0, "Reserved (KLU-era tuning knob)"),
    },
    "Driver": {
        "Number of factorizations": ("int", 1,
                                     "Re-factor count (perturbed "
                                     "diagonal) per run"),
        "Number of solves": ("int", 1, "Solves per factorization"),
        "Warm Recompute": ("bool", False,
                           "Re-factorizations after the first polish "
                           "the dense inverses from the previous "
                           "factors (Newton-Schulz, residual-gated "
                           "fallback) instead of re-factoring"),
        "Number of refinements": ("int", 0,
                                  "Grid-doubling refinement loops"),
        "Number of rhs": ("int", 1, "Right-hand sides per solve"),
        "Null Space Type": ("string", "None",
                            "None | Constant | Constant P | Checkerboard"),
        "Reynolds": ("double", 0.0,
                     "Reynolds number for generated cavity Jacobians"),
        "Read Linear System": ("bool", False,
                               "Load the system from Data Directory"),
        "Data Directory": ("string", "", "Reference-layout data dir"),
        "Store Matrix": ("bool", False, "Dump the operator after setup"),
        "Store Level Matrices": ("bool", False,
                                 "Dump every level's reduced operator "
                                 "(reference HYMLS_STORE_MATRICES)"),
        "Store Solution": ("bool", False, "Dump the final solution"),
        "Store Format": ("string", "MatrixMarket", "MatrixMarket | HDF5"),
        "Write Failed Matrix": ("bool", True,
                                "Dump FailedMatrix.mtx + FailedRhs.mtx "
                                "when a solve does not converge"),
        "Eigenvalues": ("sublist", None,
                        "Eigencomputation: How Many, Which, Target, "
                        "Convergence Tolerance, Number of Iterations, "
                        "Maximum Subspace Dimension, Restart Dimension, "
                        "Correction Iterations, Bordered Solver (bool: "
                        "bordered correction preconditioning), Use "
                        "Arnoldi (bool: ARPACK shift-invert with "
                        "multilevel inner solves instead of JDQR — "
                        "required for singular mass matrices)"),
        "Galeri Label": ("string", "", "Explicit generator label"),
        "Galeri": ("sublist", None, "Generator coefficient sublist"),
        "Exact Solution Available": ("bool", False,
                                     "Dataset provides sol.mtx"),
        "Pressure Variable": ("int", -1, "Pressure dof index override"),
    },
    "Targets": {
        "Number of Iterations": ("int", 999, "Max Krylov iterations"),
        "Relative Residual 2-Norm": ("double", 5e-6, "Residual target"),
        "Relative Error 2-Norm": ("double", 5e-6,
                                  "Error target vs reference solution"),
        "Number of Eigenvalue Iterations": ("int", 9999,
                                            "Max JDQR iterations"),
        "Error Eigenvalues": ("double", 1e-6,
                              "Eigenvalue accuracy target"),
    },
}


def documentation() -> str:
    """Render the catalog (reference printValidParameters)."""
    out: List[str] = []
    for sub, entries in CATALOG.items():
        out.append(f'<ParameterList name="{sub}">')
        for name, (typ, default, doc) in entries.items():
            out.append(f'  {name} ({typ}, default {default!r})')
            out.append(f'      {doc}')
        out.append("")
    return "\n".join(out)


def validate(params: Params) -> List[str]:
    """Unknown-parameter warnings (reference parameter-list validation).

    Only top-level sublists present in the catalog are checked; unknown
    SUBLISTS are ignored (applications may carry their own)."""
    import re
    warnings: List[str] = []
    for sub, entries in CATALOG.items():
        if not params.is_sublist(sub):
            continue
        known = set(entries)
        for key in params.sublist(sub).keys():
            if key in known:
                continue
            if re.match(r"Variable \d+$", key) and "Variable <i>" in known:
                continue
            if re.match(r"Retain Nodes at Level \d+$", key) and \
                    "Retain Nodes" in known:
                continue
            if re.match(r"(Separator Length|Coarsening Factor|"
                        r"Retain Nodes) \([xyz]\)$", key):
                continue
            warnings.append(f"unknown parameter '{sub}' -> '{key}'")
    return warnings
