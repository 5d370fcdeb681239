"""The distributed cases chip_smoke.py phases 25 and 26 run, and their
rank bodies.

The case builders return plain parameter dicts and scipy matrices (no
solver object), so that tests/_torch_anchors.py 25 and 26 build the JAX
package's solvers from the same inputs.  Phase 25's cases set
'Structured Apply' False, so that they run the owner-sharded halo
V-cycle; phase 26's leave it at "Auto", so that they run the structured
apply sharded over the ranks (core/structured.py ShardedApply).

`phase25(mesh)` runs in every rank of a mesh (parallel/launch.run):

  a. the cavity64_Re1000 IR Newton step (bench.py's parameters)
     distributed, and replicated on rank 0 alone;
  b. stokes128_L2's IR Newton step, the same;
  c. f64 solves distributed and replicated: GMRES on cavity64, the
     bordered cavity64 solve of phase 9, the deflated anisotropic
     Laplace of phase 18, the complex solve of phase 20;
  d. the halo V-cycle against the replicated generic apply, and the
     distributed factors against the replicated ones in the halo
     layout, on cavity64 and stokes128 in f64, with each apply's
     collective counts and bytes;
  e. the halo DIA matvec against K @ x, with the DIA kernel's launches.

`phase26(mesh)` likewise:

  a. the cavity64_Re1000 IR Newton step with 'Distributed Apply' and
     'Structured Apply' "Auto" (bench.py's parameters), and replicated on
     rank 0 alone, with the DIA kernel's launches on every rank;
  b. stokes128_L2's IR Newton step, the same;
  c. on cavity64 and stokes128_L2 in f64, one sharded structured apply
     against the replicated structured apply, with its collective
     counts and bytes beside those the design states
     (ShardedApply.traffic).

`phases25_26(mesh)` runs both in one spawn.  They return python numbers
and numpy arrays only; rank 0's record holds the replicated
counterparts.
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

import torch

#: the grid of phases 18 and 20
NX128 = 128


def cavity64_dict(dist=False, levels=1, nx=64, structured=False):
    """bench.py:_stokes_params(64, 2, 1, "Cartesian") with 'Distributed
    Apply' `dist` and 'Structured Apply' `structured` (False for phase
    25, bench.py's default "Auto" for phase 26; nx, levels: stokes128_L2
    is the same list at 128^2, L = 2)."""
    return {"Problem": {"Equations": "Stokes-C", "Dimension": 2, "nx": nx,
                        "ny": nx},
            "Solver": {"Krylov Method": "GMRES",
                       "Left or Right Preconditioning": "Right",
                       "Initial Vector": "Zero", "Distributed Apply": dist,
                       "Iterative Solver": {"Maximum Iterations": 250,
                                            "Convergence Tolerance": 1e-12}},
            "Preconditioner": {"Partitioner": "Cartesian",
                               "Separator Length": 4,
                               "Number of Levels": levels,
                               "Structured Apply": structured}}


def cavity64_matrix():
    from ..stencils.navier_stokes import cavity_jacobian
    K = cavity_jacobian(64, 64, re=1000.0).tocsr()
    return K, K @ np.random.default_rng(0).standard_normal(K.shape[0])


def stokes128_matrix(load_params):
    from ..stencils import create_matrix
    K = create_matrix(load_params(cavity64_dict(False, 2, 128))).tocsr()
    return K, K @ np.random.default_rng(1).standard_normal(K.shape[0])


def bordered_dict(dist=False):
    """Phase 9: cavity64 with the constant-pressure border ('Fix
    Pressure Level' off, 'Null Space Type' 'Constant P')."""
    d = cavity64_dict(dist)
    d["Preconditioner"]["Fix Pressure Level"] = False
    d["Driver"] = {"Null Space Type": "Constant P"}
    return d


def bordered_rhs(K, ns):
    x_ex = np.random.default_rng(7).standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    return K @ x_ex


def laplace_dict(levels, dist=False, solver=None, nx=NX128):
    """Phase 18's and 20's Laplace list (chip_smoke.py laplace_params)."""
    return {"Problem": {"Equations": "Laplace", "Dimension": 2, "nx": nx,
                        "ny": nx},
            "Driver": {},
            "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                       "Distributed Apply": dist,
                       "Iterative Solver": {"Maximum Iterations": 300,
                                            "Convergence Tolerance": 1e-10},
                       **(solver or {})},
            "Preconditioner": {"Separator Length": 4,
                               "Number of Levels": levels,
                               "Structured Apply": False}}


def aniso_matrix(nx=NX128, eps=0.01):
    from ..stencils.generators import _cross2d
    K = (-_cross2d(nx, nx, 2 + 2 * eps, -1.0, -1.0, -eps, -eps)).tocsr()
    return K, K @ np.random.default_rng(5).standard_normal(K.shape[0])


def complex_case(nx=NX128):
    """Phase 20: (A + 0.5 i I) z = b on Laplace nx^2."""
    from ..stencils import laplace2d
    A = laplace2d(nx, nx).tocsr()
    B = sp.identity(A.shape[0], format="csr") * 0.5
    rng = np.random.default_rng(11)
    z_ex = rng.standard_normal(A.shape[0]) + 1j * rng.standard_normal(
        A.shape[0])
    return A, B, A @ z_ex + 1j * (B @ z_ex), z_ex


# ---------------------------------------------------------------------------
# the rank body
# ---------------------------------------------------------------------------

def _sync(mesh):
    """All ranks' queued work done, then a barrier (one psum)."""
    from ..parallel import collectives as C
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    C.psum(mesh, torch.zeros(1, device=mesh.device))


def _relres(K, x, b):
    x = x.cpu().numpy() if torch.is_tensor(x) else x
    return float(np.linalg.norm(K @ x - b) / np.linalg.norm(b))


def _newton(mesh, K, b, d, dist, steps=2):
    """IterativeRefinementSolver on (K, d): compute, then `steps` Newton
    steps; the last one's numbers and seconds (wall clock, synchronized
    on every rank for the distributed one), and the DIA kernel's
    launches in it."""
    from .. import Params
    from ..ops.dia_spmv import dia_matvec
    from ..solvers.mixed import IterativeRefinementSolver
    from ..stencils import create_testvector
    d = {**d, "Solver": {**d["Solver"], "Distributed Apply": dist}}
    params = Params(d)
    S = IterativeRefinementSolver(K, params,
                                  testvector=create_testvector(params, K),
                                  device=mesh.device)
    S.compute()
    for _ in range(steps):
        if dist:
            _sync(mesh)
        elif mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dia_matvec.launches = 0
        t0 = time.perf_counter()
        res = S.newton_step(S.op64.vals, S.solver.op.vals, b)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t = time.perf_counter() - t0
    rec = {"iters": res.iters, "relres": _relres(K, res.x, b), "s": t,
           "shape": tuple(res.x.shape), "finite":
           bool(torch.isfinite(res.x).all()), "dtype": str(res.x.dtype),
           "launches": dia_matvec.launches,
           "structured": S.precond._structured_active}
    if dist:
        rec["dist_active"] = S.solver._dist is not None
        rec["dcompute"] = rec["dist_active"] and \
            S.solver._dist.dcompute is not None
        rec["sharded"] = S.solver._dist_structured is mesh
    return rec


def _f64_solves(mesh, dist):
    """Phase 25c on one side: iterations and true residuals."""
    from .. import Params, Preconditioner, Solver
    from ..solvers.complex_solver import ComplexSolver
    from ..stencils import create_nullspace, create_testvector
    dev = mesh.device
    out = {}

    def prec(K, d):
        params = Params(d)
        return params, Preconditioner(
            K, params, testvector=create_testvector(params, K), device=dev)

    K, b = cavity64_matrix()
    params, P = prec(K, cavity64_dict(dist))
    S = Solver(K, P, params, device=dev)
    x, res = S.apply_inverse(b)
    out["gmres_cavity64"] = {"iters": res.iters, "relres": _relres(K, x, b),
                             "dist": S._dist is not None}

    d = bordered_dict(dist)
    params, P = prec(K, d)
    ns = create_nullspace(params, K.shape[0])
    bb = bordered_rhs(K, ns)
    S = Solver(K, P, params, device=dev)
    S.set_border(ns)
    x, res = S.apply_inverse(bb)
    out["bordered_cavity64"] = {
        "iters": res.iters, "relres": _relres(K, x, bb),
        "border_coeff": float(np.abs(S._border_coeffs).max()),
        "dist": S._dist is not None}

    Ka, ba = aniso_matrix()
    params, P = prec(Ka, laplace_dict(
        2, dist, solver={"Deflated Subspace Dimension": 8}))
    S = Solver(Ka, P.compute(), params, device=dev)
    S.setup_deflation()
    x, res = S.apply_inverse(ba)
    out["deflated_aniso128"] = {"iters": res.iters,
                                "relres": _relres(Ka, x, ba),
                                "dist": S._dist is not None}

    A, B, bc, z_ex = complex_case()
    params, P = prec(A, laplace_dict(1, dist))
    CS = ComplexSolver(A, P.compute(), params, B=B, device=dev)
    z, res = CS.apply_inverse(bc)
    z = z.cpu().numpy()
    out["complex128"] = {"iters": res.iters,
                         "error": float(np.linalg.norm(z - z_ex) /
                                        np.linalg.norm(z_ex)),
                         "dist": CS._dist is not None}
    return out


def _counters(mesh):
    return {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in mesh.counters.items()}


def _halo_checks(mesh, name, K, d):
    """Phase 25d on one problem (f64): the halo apply against the
    replicated generic apply, the distributed factors against the
    replicated ones, and one apply's collectives."""
    from .. import Params, Preconditioner
    from ..parallel.dist_compute import DistributedCompute
    from ..parallel.halo_vcycle import make_halo_apply
    from ..stencils import create_testvector
    params = Params(d)
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=mesh.device).compute()
    app = make_halo_apply(P, mesh)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(K.shape[0]),
                        device=mesh.device)
    x_rep = P.apply_inverse(b)
    b_l = app.to_local(b)
    mesh.reset_counters()
    x_l = app.apply_local(b_l)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    per_apply = _counters(mesh)
    x = app.to_global(x_l)
    scale = float(x_rep.abs().max())
    rec = {"apply_rel": float((x - x_rep).abs().max()) / scale,
           "apply_exact": bool(torch.equal(x, x_rep)),
           "per_apply": per_apply}
    ref = app.stack_factors(P.factors.pruned)
    dc = DistributedCompute(P, mesh)
    mesh.reset_counters()
    got = dc.compute(torch.as_tensor(K.data, device=mesh.device))
    rec["compute_collectives"] = _counters(mesh)
    worst = 0.0
    exact = True
    for lev in range(P.max_level):
        for k in ("A11inv", "G", "A21", "blkinv"):
            a, g = ref["levels"][lev][k], got["levels"][lev][k]
            if k == "blkinv":
                valid = dc.fplans[lev]["blk_mask"].any(-1)
                a, g = a[valid], g[valid]
            if a.numel():
                worst = max(worst, float((a - g).abs().max()) /
                            max(float(a.abs().max()), 1e-300))
                exact = exact and bool(torch.equal(a, g))
    for k in ref["coarse"]:
        a, g = ref["coarse"][k], got["coarse"][k]
        worst = max(worst, float((a - g).abs().max()) /
                    max(float(a.abs().max()), 1e-300))
        exact = exact and bool(torch.equal(a, g))
    rec["factor_rel"] = worst
    rec["factor_exact"] = exact
    rec["name"] = name
    return rec


def _halo_dia(mesh, K, dtype):
    """Phase 25e: the halo DIA product of a seeded x against K @ x."""
    from ..ops.dia_spmv import dia_matvec
    from ..ops.spmv import DiaOperator
    from ..parallel import collectives as C
    from ..parallel.halo import dia_matvec_sharded, local_bands
    op = DiaOperator(K, dtype, device=mesh.device)
    x = np.random.default_rng(2).standard_normal(K.shape[0])
    n_l = K.shape[0] // mesh.size
    x_l = torch.as_tensor(x[mesh.rank * n_l:(mesh.rank + 1) * n_l],
                          dtype=dtype, device=mesh.device)
    mv = dia_matvec_sharded(op, mesh)
    bands = local_bands(op.prepare(op.vals), mesh)
    dia_matvec.launches = 0
    y_l = mv(bands, x_l)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    launches = dia_matvec.launches
    y = C.all_gather(mesh, y_l).cpu().numpy().astype(np.float64)
    xr = np.asarray(x_l.new_tensor(x).cpu().numpy(), np.float64)
    y_ref = K @ xr
    return {"rel": float(np.abs(y - y_ref).max() / np.abs(y_ref).max()),
            "launches": launches, "n": K.shape[0], "bands": len(op.offsets)}


def phase25(mesh, parts=("a", "b", "c", "d", "e")):
    """The rank body of chip_smoke.py phase 25 (module docstring)."""
    from .. import Params
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device)}
    rank0 = mesh.rank == 0
    K, b = cavity64_matrix()
    if "a" in parts:
        out["a"] = {"dist": _newton(mesh, K, b, cavity64_dict(), True)}
        _sync(mesh)
        if rank0:
            out["a"]["rep"] = _newton(mesh, K, b, cavity64_dict(), False)
        _sync(mesh)
    K128, b128 = stokes128_matrix(Params)
    d128 = cavity64_dict(False, 2, 128)
    if "b" in parts:
        out["b"] = {"dist": _newton(mesh, K128, b128, d128, True, steps=1)}
        _sync(mesh)
        if rank0:
            out["b"]["rep"] = _newton(mesh, K128, b128, d128, False,
                                      steps=1)
        _sync(mesh)
    if "c" in parts:
        out["c"] = {"dist": _f64_solves(mesh, True)}
        _sync(mesh)
        if rank0:
            out["c"]["rep"] = _f64_solves(mesh, False)
        _sync(mesh)
    if "d" in parts:
        out["d"] = [_halo_checks(mesh, "cavity64", K, cavity64_dict()),
                    _halo_checks(mesh, "stokes128_L2", K128, d128)]
    if "e" in parts:
        out["e"] = {"cavity64_f64": _halo_dia(mesh, K, torch.float64),
                    "cavity64_f32": _halo_dia(mesh, K, torch.float32),
                    "stokes128_f64": _halo_dia(mesh, K128, torch.float64)}
    return out


def _sharded_apply_check(mesh, name, K, d):
    """Phase 26c on one problem (f64): one sharded structured apply
    against the replicated structured apply, its collectives and those
    the design states."""
    from .. import Params, Preconditioner
    from ..stencils import create_testvector
    params = Params(d)
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=mesh.device).compute()
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(K.shape[0]),
                        device=mesh.device)
    x_rep = P.apply_inverse(b)
    sapply = P.sharded_sapply_fn(mesh)
    fac = P.factors
    sapply(fac, b)                      # cuts this rank's factor slabs
    _sync(mesh)
    mesh.reset_counters()
    x = sapply(fac, b)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    design = P._structured.sharded_apply_fn(mesh)
    return {"name": name, "active": P._structured_active,
            "apply_rel": float((x - x_rep).abs().max()) /
            float(x_rep.abs().max()),
            "apply_exact": bool(torch.equal(x, x_rep)),
            "per_apply": _counters(mesh),
            "design": design.traffic(x.element_size()),
            "slabs": [None if sl is None else (sl.ax, list(sl.sizes))
                      for sl in design.slabs]}


def phase26(mesh, parts=("a", "b", "c")):
    """The rank body of chip_smoke.py phase 26 (module docstring)."""
    from .. import Params
    out = {"rank": mesh.rank}
    rank0 = mesh.rank == 0
    K, b = cavity64_matrix()
    d64 = cavity64_dict(structured="Auto")
    K128, b128 = stokes128_matrix(Params)
    d128 = cavity64_dict(False, 2, 128, structured="Auto")
    for part, (KK, bb, dd, steps) in (("a", (K, b, d64, 2)),
                                      ("b", (K128, b128, d128, 1))):
        if part not in parts:
            continue
        out[part] = {"dist": _newton(mesh, KK, bb, dd, True, steps=steps)}
        _sync(mesh)
        if rank0:
            out[part]["rep"] = _newton(mesh, KK, bb, dd, False, steps=steps)
        _sync(mesh)
    if "c" in parts:
        out["c"] = [_sharded_apply_check(mesh, "cavity64", K, d64),
                    _sharded_apply_check(mesh, "stokes128_L2", K128, d128)]
    return out


def phases25_26(mesh):
    """chip_smoke.py's one spawn: phase 25, then phase 26 on the same
    ranks."""
    out = phase25(mesh)
    _sync(mesh)
    t0 = time.perf_counter()
    out["26"] = phase26(mesh)
    out["26"]["s"] = time.perf_counter() - t0
    return out


def nccl_single(mesh):
    """ppermute (to itself), psum and all_gather on device tensors over
    a world-size-1 NCCL group."""
    from ..parallel import collectives as C
    x = torch.arange(6, dtype=torch.float64, device=mesh.device)
    p = C.ppermute(mesh, x, [(0, 0)])
    s = C.psum(mesh, x)
    g = C.all_gather(mesh, x)
    torch.cuda.synchronize(mesh.device)
    return {"ppermute": p.cpu().tolist(), "psum": s.cpu().tolist(),
            "all_gather": g.cpu().tolist(),
            "devices": sorted({str(t.device) for t in (p, s, g)}),
            "counters": _counters(mesh), "x": x.cpu().tolist()}
