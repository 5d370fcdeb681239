"""Application driver: the `hymls_main <xml>` equivalent.

Replicates the reference driver loop (reference src/main.cpp:48-537 and
testSuite/integration_tests/integration_tests.cpp): build or read the
linear system, construct preconditioner + solver, run the configured
number of factorizations / solves / refinements, and check the
'Targets' sublist (max iterations, relative residual, relative error).

Torch counterpart of hymls_tpu/driver.py: the same public names, report
lines and branches; every preconditioner, Krylov and eigenvalue solve
runs on one device, the card unless `--device cpu` (or `device=`) asks
for the CPU.

Usage:
    python -m hymls_tpu_torch.driver config.xml [override.xml ...]
                                     [--device cuda|cpu]
    python -m hymls_tpu_torch.driver --params-doc
"""
from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .config import Params, load_xml
from .grid import grid_from_params
from .stencils import (create_matrix, create_testvector, create_nullspace)
from .core.preconditioner import Preconditioner
from .solvers.solver import Solver
from .utils import io as hio
from .utils.timings import Timer


@dataclass
class SolveReport:
    iters: int
    relres: float
    relerr: float
    converged: bool
    setup_time: float
    compute_time: float
    solve_time: float


@dataclass
class RunReport:
    solves: List[SolveReport] = field(default_factory=list)
    passed: bool = True
    failures: List[str] = field(default_factory=list)
    # analytic flop/byte cost model + achieved rates (reference flop
    # counters, src/HYMLS_Preconditioner.cpp:612-680)
    cost_model: Optional[dict] = None

    def check(self, cond: bool, msg: str):
        if not cond:
            self.passed = False
            self.failures.append(msg)


def _proj_params(params: Params, kind: str) -> Params:
    p = params.copy()
    p.sublist("Driver")["Null Space Type"] = kind
    return p


def get_linear_system(params: Params, with_mass: bool = False):
    """Build or read (K, b_maker, x_ex, nullspace[, mass]); reference
    integration_tests.cpp getLinearSystem + main_eigs.cpp:166-270
    (mass matrix read from the dataset, or a dummy velocity-identity /
    pressure-zero mass for Stokes)."""
    driver = params.sublist("Driver")
    mass = None
    if driver.get("Read Linear System", False):
        datadir = driver.get("Data Directory", None)
        if not datadir:
            raise ValueError("'Data Directory' not set")
        try:
            K, b, x_ex, ns, mass = hio.read_linear_system(datadir)
        except FileNotFoundError:
            # some reference datasets ship only rhs/sol (the 128^2
            # DrivenCavity dirs omit jac.mtx); the Re0 cavity Jacobian
            # is linear and exactly reproducible — reconstruct it and
            # VERIFY against the shipped pair (the 128^2 Re0 data
            # satisfies the reconstruction at ~1e-16)
            K, b, x_ex, ns, mass = _reconstruct_linear_system(
                params, datadir)
        # make sure grid info is consistent
        grid_from_params(params)
        if ns is not None and not np.any(ns):
            ns = None   # all-zero nullspace dumps carry no information
        if driver.get("Null Space Type", "None") != "None" and ns is None:
            ns = create_nullspace(params, K.shape[0])
        out = (K, b, x_ex, ns)
    else:
        K = create_matrix(params)
        ns = None
        if driver.get("Null Space Type", "None") != "None":
            ns = create_nullspace(params, K.shape[0])
        out = (K, None, None, ns)
    if not with_mass:
        return out
    if mass is None:
        mass = _dummy_mass(params, out[0].shape[0])
    return out + (mass,)


def _reconstruct_linear_system(params: Params, datadir: str):
    """Rebuild a dataset's missing Jacobian from the problem config and
    verify it against the shipped (rhs, sol) pair.  Only the linear
    (Re=0) driven-cavity operators are reconstructible this way; the
    verification gate rejects anything else."""
    import re as _re
    from .stencils.navier_stokes import cavity_jacobian
    prob = params.sublist("Problem")
    if not str(prob.get("Equations", "")).startswith("Stokes"):
        raise FileNotFoundError(f"no matrix found in {datadir} and "
                                "equations are not reconstructible")
    b = hio.read_vector(os.path.join(datadir, "rhs.mtx"))
    x_ex = hio.read_vector(os.path.join(datadir, "sol.mtx"))
    m = _re.search(r"Re(\d+)", datadir)
    re_val = float(m.group(1)) if m else 0.0
    nx = int(prob.get("nx"))
    ny = int(prob.get("ny", nx))
    K = cavity_jacobian(nx, ny, re=re_val).tocsr()
    resid = np.linalg.norm(K @ x_ex - b) / np.linalg.norm(b)
    if not resid < 1e-12:
        raise FileNotFoundError(
            f"no matrix in {datadir}; reconstructed cavity Jacobian "
            f"does not satisfy the dataset (||K sol - rhs||/||rhs|| = "
            f"{resid:.2e})")
    return K, b, x_ex, None, None


def _dummy_mass(params: Params, n: int):
    """Dummy mass matrix when none is stored (reference
    main_eigs.cpp:250-270): identity on velocities, zero on the
    pressure diagonal for Stokes-C; identity otherwise (returned as
    None — (K, I) is the standard problem)."""
    prob = params.sublist("Problem")
    eq = prob.get("Equations", "Laplace")
    if not str(eq).startswith("Stokes"):
        return None
    dim = prob.get("Dimension", 2)
    dof = dim + 1
    d = np.ones(n)
    d[dof - 1::dof] = 0.0
    import scipy.sparse as _sp
    return _sp.diags(d).tocsr()


def run_case(params: Params, dtype=torch.float64,
             device="cuda") -> RunReport:
    """One configuration at one resolution on `device`: the testSolver
    loop of the reference (integration_tests.cpp:486-677)."""
    report = RunReport()
    driver = params.sublist("Driver")
    targets = params.sublist("Targets")
    num_computes = driver.get("Number of factorizations", 1)
    num_solves = driver.get("Number of solves", 1)
    t_iters = targets.get("Number of Iterations", 9999)
    t_res = targets.get("Relative Residual 2-Norm", 1.0)
    t_err = targets.get("Relative Error 2-Norm", 1.0)

    K, b0, x_ex0, ns, mass = get_linear_system(params, with_mass=True)
    tv = create_testvector(params, K)

    from .utils.timings import start_memory, stop_memory
    timer = Timer("driver")
    start_memory("initialize")
    with timer.scope("initialize"):
        P = Preconditioner(K, params, testvector=tv, dtype=dtype,
                           device=device)
        S = Solver(K, P, params, dtype=dtype, device=device)
        if ns is not None:
            S.set_border(ns)
    stop_memory("initialize")

    # NOT seed 42: the Solver's 'Initial Vector: Random' stream uses 42,
    # and an identical first draw would make x0 == x_ex (a vacuous
    # 0-iteration solve)
    rng = np.random.default_rng(1234)
    read_problem = driver.get("Read Linear System", False)

    Kc = K
    for f in range(num_computes):
        scaling = 1.0 / (10.0 * f + 1.0)
        Kc = K * scaling if f > 0 else K
        with timer.scope("compute"):
            # 'Warm Recompute': Newton-Schulz-polish the dense inverses
            # from the previous factorization instead of re-factoring
            # (Preconditioner.recompute; residual-gated per inverse)
            if f > 0 and driver.get("Warm Recompute", False):
                P.recompute(Kc)
            else:
                P.compute(Kc if f > 0 else None)
            S.set_matrix(Kc)
            if params.sublist("Solver").get("Use Deflation", False):
                S.setup_deflation()
            # true completion fence: CUDA work returns to the host at
            # enqueue, which would let the factorization leak into the
            # 'solve' timer
            from .utils.timings import sync
            sync(P.factors.tree)

        for s in range(num_solves):
            if not read_problem or b0 is None:
                # generate the rhs from a random exact solution (the
                # reference does the same when 'RHS Available' is 0)
                x_ex = rng.standard_normal(K.shape[0])
                if ns is not None:
                    x_ex -= ns @ (ns.T @ x_ex)
                b = Kc @ x_ex
            else:
                x_ex = x_ex0
                b = b0 * scaling

            with timer.scope("solve"):
                x, res = S.apply_inverse(b)
                x = x.cpu().numpy()

            # Subtract the (checkerboard) pressure mode from the error
            # for singular Stokes systems (reference
            # integration_tests.cpp:584-601).
            eqn = params.sublist("Problem").get("Equations", "Laplace")
            proj = None
            if x_ex is not None and eqn in ("Stokes-C", "Darcy"):
                proj = create_nullspace(_proj_params(params, "Constant P"),
                                        K.shape[0])
            elif x_ex is not None and eqn in ("Stokes-B", "Stokes-L",
                                              "Stokes-T"):
                proj = create_nullspace(_proj_params(params, "Checkerboard"),
                                        K.shape[0])
            if proj is not None:
                err = x - x_ex
                x = x - proj @ (proj.T @ err)

            relres = float(np.linalg.norm(Kc @ x - b) / np.linalg.norm(b))
            if x_ex is not None:
                relerr = float(np.linalg.norm(x - x_ex)
                               / np.linalg.norm(b) * scaling)
            else:
                relerr = 0.0

            sr = SolveReport(
                iters=int(res.iters), relres=relres, relerr=relerr,
                converged=bool(res.converged),
                setup_time=timer.total("initialize"),
                compute_time=timer.total("compute"),
                solve_time=timer.total("solve"))
            report.solves.append(sr)

            if not sr.converged and driver.get("Write Failed Matrix",
                                               True):
                # diagnostic dump on non-convergence (reference
                # FailedMatrix.txt, src/HYMLS_BaseSolver.cpp:368-382);
                # the module's `hio`: an import here would make the name
                # local to run_case and break the dumps below
                hio.write_matrix("FailedMatrix.mtx", Kc)
                hio.write_vector("FailedRhs.mtx", b)
                print("WARNING: solve did not converge; wrote "
                      "FailedMatrix.mtx / FailedRhs.mtx")

            report.check(sr.iters <= t_iters,
                         f"iters {sr.iters} > target {t_iters}")
            report.check(relres <= t_res,
                         f"relres {relres:.3e} > target {t_res:g}")
            report.check(relerr <= t_err,
                         f"relerr {relerr:.3e} > target {t_err:g}")

    # analytic cost model + achieved rates (reference flop counters,
    # src/HYMLS_Preconditioner.cpp:612-680; printed by main's final
    # report)
    try:
        from .utils.flops import preconditioner_flops
        fm = preconditioner_flops(P)
        ct = timer.total("compute")
        st = timer.total("solve")
        iters_tot = sum(s.iters for s in report.solves)
        report.cost_model = {
            "compute_gflop": fm["compute_flops"] / 1e9,
            "apply_mflop": fm["apply_flops"] / 1e6,
            "apply_mb": fm["apply_bytes"] / 1e6,
            "compute_gflops_achieved":
                fm["compute_flops"] * num_computes / max(ct, 1e-12) / 1e9,
            "apply_gflops_achieved":
                fm["apply_flops"] * iters_tot / max(st, 1e-12) / 1e9,
            "apply_gbps_achieved":
                fm["apply_bytes"] * iters_tot / max(st, 1e-12) / 1e9,
        }
    except Exception:       # cost model must never fail a run
        report.cost_model = None

    # optional dumps (reference 'Store Solution'/'Store Matrix' flags,
    # src/main.cpp:129-131,484-490; 'Store Format'='HDF5' uses the
    # EpetraExt_HDF5-equivalent container)
    if driver.get("Store Format", "MatrixMarket") == "HDF5":
        objs = {}
        if driver.get("Store Matrix", False):
            objs["matrix"] = K
        if driver.get("Store Solution", False) and report.solves:
            objs["solution"] = x
        if objs:
            hio.write_hdf5("dump.h5", **objs)
    else:
        if driver.get("Store Matrix", False):
            hio.write_matrix("matrix_dump.mtx", K)
        if driver.get("Store Level Matrices", False):
            # reference HYMLS_STORE_MATRICES: every operator per level
            P.dump_levels("level_dump")
        if driver.get("Store Solution", False) and report.solves:
            hio.write_vector("solution_dump.mtx", x)

    # eigenvalue computation (reference main_eigs / testEigenSolver)
    if driver.is_sublist("Eigenvalues"):
        from .solvers.eigen import JDQR, shift_invert_eigs
        eig = driver.sublist("Eigenvalues")
        t_eig_iter = targets.get("Number of Eigenvalue Iterations", 9999)
        t_eig_err = targets.get("Error Eigenvalues", None)
        which = eig.get("Which", "SM")
        how_many = eig.get("How Many", 10)
        target = eig.get("Target", 0.0)
        # generalized problem (K, M): mass from the dataset, or the
        # velocity-identity dummy mass for Stokes (reference
        # main_eigs.cpp:368-396 sets eigProblem->setM(M))
        M = mass
        if eig.get("Use Arnoldi", False):
            # ARPACK shift-invert fallback with the multilevel solver
            # doing the inner solves (the reference's Anasazi BKS +
            # HYMLS::Solver path, src/main_eigs.cpp non-PHIST branch)
            eres = shift_invert_eigs(
                K, M, S, k=max(2 * how_many, how_many + 2),
                target=target,
                tol=eig.get("Convergence Tolerance", 1e-8))
            order = np.argsort(-np.real(eres.values)) if which == "LR" \
                else np.argsort(np.abs(eres.values - target))
            eres.values = eres.values[order][:how_many]
            eres.vectors = eres.vectors[:, order][:, :how_many]
            eres.converged = min(eres.converged, how_many)
        else:
            # JDQR with preconditioned correction equations; complex
            # Ritz pairs lock on-device through complex-shifted
            # correction solves (reference PhistSolMgr subspacejada +
            # HYMLS_PhistCustomCorrectionSolver.cpp)
            jd = JDQR(K, M, P, params, dtype=dtype, device=device)
            eres = jd.solve()
        report.check(eres.converged >= how_many,
                     f"only {eres.converged}/{how_many} eigenpairs")
        if eres.iterations >= 0:
            report.check(eres.iterations <= t_eig_iter,
                         f"eig iters {eres.iterations} > {t_eig_iter}")
        if t_eig_err is not None and eres.converged:
            # 'Error Eigenvalues' target: eigenpair residuals
            # ||K v - lambda M v|| / ||v|| (the executable form of the
            # reference's eigenvalue-accuracy check,
            # integration_tests.cpp Targets)
            V = eres.vectors
            lam = eres.values
            R = K @ V - (M @ V if M is not None else V) * lam[None, :]
            errs = np.linalg.norm(R, axis=0) / np.linalg.norm(V, axis=0)
            report.check(float(np.max(np.abs(errs))) <= 10 * t_eig_err,
                         f"eig residuals {errs.max():.2e} > "
                         f"{10 * t_eig_err:.2e}")
    return report


def refinements(params: Params,
                max_refines: Optional[int] = None) -> List[Params]:
    """The Params of every grid of the refinement loop, each twice as
    fine as the one before."""
    driver = params.sublist("Driver")
    prob = params.sublist("Problem")
    num_refines = driver.get("Number of refinements", 0)
    if max_refines is not None:
        num_refines = min(num_refines, max_refines)
    dim = prob.get("Dimension", 2)
    nx = prob.get("nx", 32)
    ny = prob.get("ny", nx)
    nz = prob.get("nz", nx if dim > 2 else 1)

    out = []
    for ref in range(num_refines + 1):
        p = params.copy()
        p.sublist("Problem")["nx"] = nx
        p.sublist("Problem")["ny"] = ny
        p.sublist("Problem")["nz"] = nz
        out.append(p)
        nx *= 2
        ny *= 2
        if dim > 2:
            nz *= 2
    return out


def run_with_refinements(params: Params, dtype=torch.float64,
                         max_refines: Optional[int] = None,
                         device="cuda") -> List[RunReport]:
    """Grid-refinement loop (reference integration_tests.cpp:157-211)."""
    return [run_case(p, dtype=dtype, device=device)
            for p in refinements(params, max_refines)]


def run_comparison(params: Params) -> SolveReport:
    """Solve the same system with a conventional one-level
    preconditioner for comparison (the role of the reference's
    main_ifpack driver, src/main_ifpack.cpp:111,207-222, which runs
    Ifpack ILU or ML AMG instead of HYMLS).  'Driver' ->
    'Preconditioning Method' selects 'ILU' (default), 'Jacobi' or
    'None'; this is a host-side reference path (scipy), not a device
    production path."""
    import time as _time
    import scipy.sparse.linalg as spla

    driver = params.sublist("Driver")
    method = driver.get("Preconditioning Method", "ILU")
    slist = params.sublist("Solver")
    it = slist.sublist("Iterative Solver")
    maxiter = it.get("Maximum Iterations", 500)
    tol = it.get("Convergence Tolerance", 1e-8)

    K, b, x_ex, ns = get_linear_system(params)
    n = K.shape[0]
    rng = np.random.default_rng(42)
    if b is None:
        x_ex = rng.standard_normal(n)
        b = K @ x_ex

    t0 = _time.perf_counter()
    if method == "ILU":
        ilu_list = driver.sublist("Ifpack")
        ilu = spla.spilu(K.tocsc(),
                         drop_tol=ilu_list.get("Drop Tolerance", 0.0),
                         fill_factor=ilu_list.get("Fill Factor", 10.0))
        M = spla.LinearOperator((n, n), matvec=ilu.solve)
    elif method == "Jacobi":
        d = K.diagonal()
        d = np.where(np.abs(d) > 1e-300, d, 1.0)
        M = spla.LinearOperator((n, n), matvec=lambda x: x / d)
    elif method == "None":
        M = None
    else:
        raise ValueError(f"unknown Preconditioning Method {method!r}")
    compute_time = _time.perf_counter() - t0

    iters = 0

    def cb(_):
        nonlocal iters
        iters += 1

    t0 = _time.perf_counter()
    x, info = spla.gmres(K, b, rtol=tol, maxiter=maxiter, M=M,
                         restart=min(maxiter, 200), callback=cb,
                         callback_type="pr_norm")
    solve_time = _time.perf_counter() - t0
    relres = float(np.linalg.norm(K @ x - b) / np.linalg.norm(b))
    relerr = float(np.linalg.norm(x - x_ex) / np.linalg.norm(x_ex)) \
        if x_ex is not None else float("nan")
    return SolveReport(iters=iters, relres=relres, relerr=relerr,
                       converged=(info == 0), setup_time=0.0,
                       compute_time=compute_time, solve_time=solve_time)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m hymls_tpu_torch.driver",
        description="Run XML configurations through the multilevel "
                    "solver and check their 'Targets'.")
    ap.add_argument("configs", nargs="*", metavar="config.xml",
                    help="the configuration, then overrides applied in "
                         "order")
    ap.add_argument("--params-doc", action="store_true",
                    help="print the documented parameters and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every solve (default: cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.params_doc:
        # reference printValidParameters (src/main.cpp:502-508)
        from .params_doc import documentation
        print(documentation())
        return 0
    argv = args.configs
    if not argv:
        print("usage: python -m hymls_tpu_torch.driver <config.xml> "
              "[override.xml ...] [--device cuda|cpu] | --params-doc")
        return 1
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"ERROR: device {args.device!r} requested, but no CUDA "
              f"device is available; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    params = load_xml(argv[0])
    for extra in argv[1:]:
        params.update_from(load_xml(extra))

    from .params_doc import validate
    for w in validate(params):
        print(f"WARNING: {w}")

    reports = run_with_refinements(params, device=device)
    ok = all(r.passed for r in reports)
    for i, r in enumerate(reports):
        for s in r.solves:
            print(f"refinement {i}: iters={s.iters} relres={s.relres:.3e} "
                  f"relerr={s.relerr:.3e} "
                  f"[compute {s.compute_time:.2f}s solve {s.solve_time:.2f}s]")
        for msg in r.failures:
            print(f"refinement {i}: FAILED: {msg}")
        if r.cost_model:
            c = r.cost_model
            print(f"refinement {i}: cost model: factor "
                  f"{c['compute_gflop']:.2f} GFLOP "
                  f"({c['compute_gflops_achieved']:.1f} GFLOP/s achieved), "
                  f"V-cycle {c['apply_mflop']:.2f} MFLOP / "
                  f"{c['apply_mb']:.2f} MB "
                  f"({c['apply_gflops_achieved']:.1f} GFLOP/s, "
                  f"{c['apply_gbps_achieved']:.1f} GB/s achieved)")
    # aggregated timing table at exit (reference Tools::PrintTiming,
    # src/main.cpp:515) + host and CUDA memory reports (the latter
    # touches no CUDA state unless the run used the card)
    from .utils.timings import (print_timing, device_memory_report,
                                host_memory_report)
    print(print_timing())
    print(host_memory_report())
    print(device_memory_report())
    print("ALL TESTS PASSED" if ok else "TESTS FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
