"""Rank bodies of the distributed port tests: each runs in every rank
spawned by `hymls_tpu_torch.parallel.launch.run` and returns numpy
results for the parent test to compare.  Nothing here imports jax or
hymls_tpu (the children run the port alone)."""
import time

import numpy as np
import scipy.sparse as sp

import torch

from hymls_tpu_torch import Params, Preconditioner, Solver
from hymls_tpu_torch.parallel import collectives as C
from hymls_tpu_torch.stencils import create_matrix, create_testvector


def _np(t):
    return t.detach().cpu().numpy()


def precond_params(eq, nx, levels, part="Cartesian", dim=2, dof=None,
                   solver=None):
    prob = {"Equations": eq, "Dimension": dim, "nx": nx, "ny": nx}
    if dim == 3:
        prob["nz"] = nx
    if dof:
        prob["Degrees of Freedom"] = dof
    p = {"Problem": prob,
         "Preconditioner": {"Partitioner": part, "Separator Length": 4,
                            "Number of Levels": levels,
                            "Structured Apply": False}}
    if solver is not None:
        p["Solver"] = solver
    return p


def build_precond(pdict, device, K=None):
    params = Params(pdict)
    if K is None:
        K = create_matrix(params)
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=device).compute()
    return K, P


def neumann_bordered(device):
    """Laplace 32^2 with Neumann boundaries, L = 2, bordered with its
    constant null space (tests/test_halo_vcycle.py's bordered case)."""
    from hymls_tpu_torch.stencils import create_nullspace, laplace2d_neumann
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2, "nx": 32,
                    "ny": 32},
        "Driver": {"Null Space Type": "Constant"},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 2,
                           "Structured Apply": False}})
    K = laplace2d_neumann(32, 32)
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=device)
    ns = create_nullspace(params, K.shape[0])
    P.set_border(ns)
    P.compute()
    return K, P, ns


# ---------------------------------------------------------------------------
# launch and the primitives
# ---------------------------------------------------------------------------

def primitives(mesh):
    """ppermute on a ring and on a non-wrapping pair list, psum (real
    and complex), tiled all_gather with a zero-size shard, and the
    counters they leave."""
    r, n = mesh.rank, mesh.size
    x = torch.arange(4, dtype=torch.float64, device=mesh.device) + 10 * r
    mesh.reset_counters()
    out = {"ring": _np(C.ppermute(mesh, x, [(i, (i + 1) % n)
                                            for i in range(n)], tag="ring")),
           "shift": _np(C.shift(mesh, x, -1, tag="shift")),
           "psum": _np(C.psum(mesh, x)),
           "psum_c": _np(C.psum(mesh, torch.complex(x, -2 * x)))}
    sizes = [(2 * i) % 3 for i in range(n)]          # 0, 2, 1, 0, ...
    part = torch.full((sizes[r], 2), float(r), dtype=torch.float64)
    out["gather"] = _np(C.all_gather(mesh, part, sizes=sizes))
    out["gather_equal"] = _np(C.all_gather(mesh, x[:2]))
    out["x"] = _np(x)
    out["counters"] = {k: dict(v) for k, v in mesh.counters.items()}
    out["rolls"] = slab_rolls(mesh)
    # the same on a mesh of ranks 0 and 1 (every rank joins new_group)
    import torch.distributed as dist
    from hymls_tpu_torch.parallel.mesh import Mesh
    pair = dist.new_group([0, 1])
    if r < 2:
        out["rolls2"] = slab_rolls(Mesh(pair, backend="gloo",
                                        device=mesh.device))
    return out


#: the box grid the roll test splits: 3 planes along K (2/1 on 2 ranks,
#: one each on 3), 7 along J (uneven on 2 and 3 ranks: 4/3 and 3/2/2)
#: and 6 along I (even on 2 and 3 ranks)
ROLL_GRID = (3, 7, 6, 2)
ROLL_SHIFTS = (-2, -1, 1, 2)


def roll_grid():
    return np.random.default_rng(3).standard_normal(ROLL_GRID)


def slab_rolls(mesh):
    """core/structured.py roll_slab on this rank's slab of `roll_grid()`
    split along each box axis, for the shifts of ROLL_SHIFTS no wider
    than the smallest slab, each gathered whole (for the parent to hold
    against torch.roll of the whole grid); and whether a shift wider
    than the smallest slab raises."""
    from hymls_tpu_torch.core.structured import (Slab, balanced_split,
                                                 roll_slab)
    g = torch.as_tensor(roll_grid(), device=mesh.device)
    out = {}
    for ax in (0, 1, 2):
        sl = Slab(ax, tuple(balanced_split(g.shape[ax], mesh.size)))
        t = g.narrow(ax, sl.start(mesh.rank), sl.sizes[mesh.rank])
        for s in ROLL_SHIFTS:
            if abs(s) > min(sl.sizes):
                continue
            y = roll_slab(mesh, t, sl, s)
            out[(ax, s)] = _np(C.all_gather(mesh, y.movedim(ax, 0),
                                            sizes=sl.sizes).movedim(0, ax))
    try:
        wide = Slab(1, tuple(balanced_split(g.shape[1], mesh.size)))
        roll_slab(mesh, g.narrow(1, 0, wide.sizes[mesh.rank]), wide,
                  min(wide.sizes) + 1)
        out["wide"] = None
    except ValueError as e:
        out["wide"] = str(e)
    return out


def fail_on(mesh, rank):
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return mesh.rank


def hang(mesh):
    """Rank 0 waits in a psum that no other rank joins."""
    if mesh.rank == 0:
        C.psum(mesh, torch.ones(1))
    else:
        time.sleep(600)


# ---------------------------------------------------------------------------
# the halo DIA and the all-gather V-cycle
# ---------------------------------------------------------------------------

def halo_dia(mesh, cases):
    """Per case (eq, nx, dim): y = K x by the halo DIA matvec, gathered;
    and the DIA launches the local products made (0 on the CPU)."""
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.ops.spmv import DiaOperator
    from hymls_tpu_torch.parallel.halo import dia_matvec_sharded, local_bands
    out = []
    for eq, nx, dim in cases:
        K = create_matrix(Params(precond_params(eq, nx, 1, dim=dim)))
        op = DiaOperator(K, torch.float64, device=mesh.device)
        x = np.random.default_rng(nx).standard_normal(K.shape[0])
        n_l = K.shape[0] // mesh.size
        x_l = torch.as_tensor(x[mesh.rank * n_l:(mesh.rank + 1) * n_l],
                              device=mesh.device)
        mv = dia_matvec_sharded(op, mesh)
        mesh.reset_counters()
        dia_matvec.launches = 0
        y_l = mv(local_bands(op.prepare(op.vals), mesh), x_l)
        out.append({"y": _np(C.all_gather(mesh, y_l)), "x": x,
                    "words": dict(mesh.counters["ppermute_words"]),
                    "launches": dia_matvec.launches})
    return out


def gather_vcycle(mesh, cases):
    """Per case: max |x_allgather - x_replicated| / max |x_replicated|
    of the all-gather V-cycle (parallel/vcycle.py) and its all_gather
    calls."""
    from hymls_tpu_torch.parallel.vcycle import make_sharded_apply, \
        shard_factors
    out = []
    for case in cases:
        K, P = build_precond(precond_params(*case), mesh.device)
        b = torch.as_tensor(np.random.default_rng(0).standard_normal(
            K.shape[0]), device=mesh.device)
        apply = make_sharded_apply(P, mesh)
        fac, pl = shard_factors(P, mesh)
        mesh.reset_counters()
        x = apply(fac, pl, b)
        x_rep = P.apply_inverse(b)
        out.append({"diff": float((x - x_rep).abs().max() /
                                  x_rep.abs().max()),
                    "all_gather": mesh.counters["all_gather"]["calls"]})
    return out


# ---------------------------------------------------------------------------
# the halo V-cycle
# ---------------------------------------------------------------------------

def halo_vcycle(mesh, cases):
    """Per case: the halo apply of a seeded b (gathered), the replicated
    generic apply, whether they are equal bit for bit, and one
    apply_local's counters and per-level words sent."""
    from hymls_tpu_torch.parallel.halo_vcycle import make_halo_apply
    out = []
    for case in cases:
        K, P = build_precond(precond_params(*case), mesh.device)
        app = make_halo_apply(P, mesh)
        b = torch.as_tensor(np.random.default_rng(0).standard_normal(
            K.shape[0]), device=mesh.device)
        x_rep = P.apply_inverse(b)
        b_l = app.to_local(b)
        mesh.reset_counters()
        x_l = app.apply_local(b_l)
        counters = {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in mesh.counters.items()}
        x = app.to_global(x_l)
        out.append({"x": _np(x), "x_rep": _np(x_rep),
                    "equal": bool(torch.equal(x, x_rep)),
                    "counters": counters,
                    "B": [m["B"] for m in app.meta]})
    K, P, ns = neumann_bordered(mesh.device)
    app = make_halo_apply(P, mesh)
    rng = np.random.default_rng(4)
    b = torch.as_tensor(rng.standard_normal(K.shape[0]), device=mesh.device)
    t = torch.as_tensor(rng.standard_normal(ns.shape[1]), device=mesh.device)
    x_r, s_r = P.apply_inverse_bordered(b, t)
    mesh.reset_counters()
    x_h, s_h = app.apply_bordered(b, t)
    out.append({"x": _np(x_h), "s": _np(s_h), "x_rep": _np(x_r),
                "s_rep": _np(s_r), "psum": mesh.counters["psum"]["calls"],
                "equal": bool(torch.equal(x_h, x_r))})
    return out


# ---------------------------------------------------------------------------
# the distributed factorization
# ---------------------------------------------------------------------------

def dist_compute(mesh, cases):
    """Per case (precond_params args, factor precision): the relative
    difference, per level and factor, between the distributed factors
    and the replicated factors stacked into the halo layout (block
    slots that hold a block only); the coarse factor's; the
    factorization's all_gathers and the elements they gathered; and
    the halo apply on the distributed factors against the replicated
    apply."""
    from hymls_tpu_torch.parallel.dist_compute import DistributedCompute
    from hymls_tpu_torch.parallel.halo_vcycle import make_halo_apply
    out = []
    for case, fprec in cases:
        pd = precond_params(*case)
        dtype = torch.float64
        if fprec is not None:
            pd["Preconditioner"]["Factor Precision"] = fprec
            dtype = torch.float32
        params = Params(pd)
        K = create_matrix(params)
        P = Preconditioner(K, params, testvector=create_testvector(params, K),
                           dtype=dtype, device=mesh.device).compute()
        app = make_halo_apply(P, mesh)
        ref = app.stack_factors(P.factors.pruned)
        dc = DistributedCompute(P, mesh)
        mesh.reset_counters()
        got = dc.compute(torch.as_tensor(K.tocsr().data, device=mesh.device))
        gathers = dict(mesh.counters["all_gather"])
        diffs = {}
        for l in range(P.max_level):
            for k in ("A11inv", "G", "A21", "blkinv"):
                a, g = ref["levels"][l][k], got["levels"][l][k]
                if k == "blkinv":
                    # padded block slots hold block 0 in the stacked
                    # layout, identity in the distributed one; the apply
                    # reads neither
                    valid = dc.fplans[l]["blk_mask"].any(-1)
                    a, g = a[valid], g[valid]
                scale = float(a.abs().max()) if a.numel() else 1.0
                diffs[f"{l}:{k}"] = float((a - g).abs().max()) / \
                    max(scale, 1e-300) if a.numel() else 0.0
                diffs[f"{l}:{k}:dtype"] = str(g.dtype)
        for key in ref["coarse"]:
            a, g = ref["coarse"][key], got["coarse"][key]
            diffs[f"coarse:{key}"] = float((a - g).abs().max()) / max(
                float(a.abs().max()), 1e-300)
        b = torch.as_tensor(np.random.default_rng(0).standard_normal(
            K.shape[0]), dtype=dtype, device=mesh.device)
        x_rep = P.apply_inverse(b)
        app.factors = got
        x = app(b)
        out.append({"diffs": diffs, "gathers": gathers,
                    "apply": float((x - x_rep).abs().max()) /
                    float(x_rep.abs().max())})
    return out


# ---------------------------------------------------------------------------
# the distributed solves
# ---------------------------------------------------------------------------

def _solve_params(eq, nx, levels, dist, method="GMRES", maxiter=60,
                  tol=1e-10, dim=2):
    return precond_params(eq, nx, levels, dim=dim, solver={
        "Krylov Method": method,
        "Left or Right Preconditioning": "Right",
        "Distributed Apply": dist,
        "Iterative Solver": {"Maximum Iterations": maxiter,
                             "Convergence Tolerance": tol}})


def _plain_solve(mesh, eq, nx, levels, method, maxiter, dist):
    params = Params(_solve_params(eq, nx, levels, dist, method, maxiter))
    K = create_matrix(params)
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=mesh.device)
    S = Solver(K, P, params, device=mesh.device)
    b = np.random.default_rng(0).standard_normal(K.shape[0])
    if method == "CG":
        b = K @ b
    x, res = S.apply_inverse(b)
    return S, _np(x), res


def _bordered_solve(mesh, dist):
    params = Params(_solve_params("Stokes-C", 32, 2, dist, maxiter=200))
    K = create_matrix(params)
    n = K.shape[0]
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=mesh.device)
    S = Solver(K, P, params, device=mesh.device)
    V = np.zeros((n, 1))
    V[2::3, 0] = 1.0
    V /= np.linalg.norm(V)
    b = K @ np.random.default_rng(7).standard_normal(n)
    S.set_border(V)
    x, res = S.apply_inverse(b)
    return S, _np(x), res, S._border_coeffs


def aniso_matrix(nx=32, eps=0.01):
    """tests/test_dist_solve.py's anisotropic Laplace."""
    from hymls_tpu_torch.stencils.generators import _cross2d
    return -_cross2d(nx, nx, 2 + 2 * eps, -1.0, -1.0, -eps, -eps)


def _deflated_solve(mesh, dist, structured=False):
    K = aniso_matrix()
    pd = precond_params("Laplace", 32, 2, solver={
        "Krylov Method": "GMRES", "Initial Vector": "Zero",
        "Distributed Apply": dist, "Deflated Subspace Dimension": 8,
        "Iterative Solver": {"Maximum Iterations": 100,
                             "Convergence Tolerance": 1e-10}})
    pd["Preconditioner"]["Structured Apply"] = structured
    params = Params(pd)
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=mesh.device).compute()
    S = Solver(K, P, params, device=mesh.device)
    S.setup_deflation()
    x_ex = np.random.default_rng(5).standard_normal(K.shape[0])
    x, res = S.apply_inverse(K @ x_ex)
    return S, _np(x), res, x_ex


def _complex_solve(mesh, dist, bordered, structured=False):
    from hymls_tpu_torch.solvers.complex_solver import ComplexSolver
    from hymls_tpu_torch.stencils import laplace2d
    A = laplace2d(32, 32)
    n = A.shape[0]
    pd = precond_params("Laplace", 32, 2, solver={
        "Krylov Method": "GMRES", "Distributed Apply": dist,
        "Iterative Solver": {"Maximum Iterations": 150 if bordered else 100,
                             "Convergence Tolerance": 1e-10}})
    pd["Preconditioner"]["Structured Apply"] = structured
    params = Params(pd)
    P = Preconditioner(A, params, testvector=create_testvector(params, A),
                       device=mesh.device).compute()
    if bordered:
        B = sp.identity(n, format="csr") * 0.25
        rng = np.random.default_rng(13)
        V = rng.standard_normal((n, 1))
        V /= np.linalg.norm(V)
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        CS = ComplexSolver(A, P, params, B=B,
                           device=mesh.device).set_border(V)
    else:
        B = sp.identity(n, format="csr") * 0.5
        rng = np.random.default_rng(11)
        z_ex = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        b = A @ z_ex + 1j * (B @ z_ex)
        CS = ComplexSolver(A, P, params, B=B, device=mesh.device)
    z, res = CS.apply_inverse(b)
    return CS, _np(z), res


def mixed_params(dist, fprec=None, levels=2, structured=False):
    """tests/test_dist_solve.py:_build_mixed's parameters (with
    `levels` 1 and `structured` "Auto": its
    test_dist_structured_mixed_newton_step's)."""
    prec = {"Separator Length": 4, "Number of Levels": levels,
            "Structured Apply": structured, "Schur Assembly": "Full f64"}
    if fprec is not None:
        prec["Factor Precision"] = fprec
    return {"Problem": {"Equations": "Stokes-C", "Dimension": 2, "nx": 32,
                        "ny": 32},
            "Solver": {"Krylov Method": "GMRES",
                       "Left or Right Preconditioning": "Right",
                       "Distributed Apply": dist,
                       "Iterative Solver": {"Maximum Iterations": 200,
                                            "Convergence Tolerance": 1e-10}},
            "Preconditioner": prec}


def _newton_step(mesh, dist, fprec, **kw):
    """(solver, x, result, b, refinement passes) of one IR Newton step."""
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    from hymls_tpu_torch.utils.timings import counter_snapshot
    params = Params(mixed_params(dist, fprec, **kw))
    K = create_matrix(params)
    S = IterativeRefinementSolver(K, params,
                                  testvector=create_testvector(params, K),
                                  device=mesh.device)
    S.compute()
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    before = counter_snapshot().get("hymls.refine.passes", 0)
    res = S.newton_step(S.op64.vals, S.solver.op.vals, b)
    passes = counter_snapshot()["hymls.refine.passes"] - before
    return S, _np(res.x), res, b, passes


def _record(res, x, S=None):
    rec = {"iters": int(res.iters), "relres": float(res.relres), "x": x}
    if S is not None:
        rec["dist"] = getattr(S, "_dist", None) is not None or \
            getattr(getattr(S, "solver", None), "_dist", None) is not None
    return rec


def dist_solves(mesh, which):
    """The distributed solves of tests/test_dist_solve.py on the port,
    each beside the replicated port solve (computed on rank 0 only),
    with the all_gather calls per GMRES iteration of the plain solve."""
    out = {}
    rank0 = mesh.rank == 0
    for name in which:
        rec = {}
        if name in ("gmres", "cg", "gmres_l1"):
            method = "CG" if name == "cg" else "GMRES"
            eq, nx, levels = ("Laplace", 32, 1) if name == "gmres_l1" else \
                ("Stokes-C", 32, 2) if name == "gmres" else ("Laplace", 32, 2)
            mesh.reset_counters()
            S, x, res = _plain_solve(mesh, eq, nx, levels, method, 60, True)
            rec["dist"] = _record(res, x, S)
            rec["counters"] = {k: (dict(v) if isinstance(v, dict) else v)
                               for k, v in mesh.counters.items()}
            rec["dcompute"] = S._dist is not None and \
                S._dist.dcompute is not None
            if rank0:
                S0, x0, r0 = _plain_solve(mesh, eq, nx, levels, method, 60,
                                          False)
                rec["rep"] = _record(r0, x0)
        elif name == "bordered":
            S, x, res, s = _bordered_solve(mesh, True)
            rec["dist"] = dict(_record(res, x, S), s=s)
            if rank0:
                S0, x0, r0, s0 = _bordered_solve(mesh, False)
                rec["rep"] = dict(_record(r0, x0), s=s0)
        elif name == "deflated":
            S, x, res, x_ex = _deflated_solve(mesh, True)
            rec["dist"] = dict(_record(res, x, S), x_ex=x_ex)
            if rank0:
                S0, x0, r0, _ = _deflated_solve(mesh, False)
                rec["rep"] = _record(r0, x0)
        elif name in ("complex", "complex_bordered"):
            bord = name == "complex_bordered"
            CS, z, res = _complex_solve(mesh, True, bord)
            rec["dist"] = _record(res, z, CS)
            if rank0:
                _, z0, r0 = _complex_solve(mesh, False, bord)
                rec["rep"] = _record(r0, z0)
        elif name in ("newton", "newton_f64"):
            fprec = "f64" if name == "newton_f64" else None
            S, x, res, b, passes = _newton_step(mesh, True, fprec)
            rec["dist"] = dict(_record(res, x, S), b=b, passes=passes,
                               dcompute=S.solver._dist.dcompute is not None)
            if rank0:
                _, x0, r0, _, p0 = _newton_step(mesh, False, fprec)
                rec["rep"] = dict(_record(r0, x0), passes=p0)
        elif name == "bgrid":
            # configs/stokes_L2.xml at 8^3 with the B-grid transform: not
            # distributed (the reference's distributed solve returns NaN
            # there); the port warns and solves replicated
            import os
            import warnings
            from hymls_tpu_torch.config import load_xml
            from hymls_tpu_torch.tools.driver_cases import CONFIGS_DIR
            p = load_xml(os.path.join(CONFIGS_DIR, "stokes_L2.xml"))
            for k in ("nx", "ny", "nz"):
                p.sublist("Problem")[k] = 8
            p.sublist("Preconditioner")["B-Grid Transform"] = True
            p.sublist("Preconditioner")["Structured Apply"] = False
            p.sublist("Solver")["Distributed Apply"] = True
            p.sublist("Solver")["Krylov Method"] = "GMRES"
            it = p.sublist("Solver").sublist("Iterative Solver")
            it["Maximum Iterations"] = 200
            it["Convergence Tolerance"] = 1e-8
            K = create_matrix(p).tocsr()
            P = Preconditioner(K, p, testvector=create_testvector(p, K),
                               device=mesh.device)
            S = Solver(K, P, p, device=mesh.device)
            b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                x, res = S.apply_inverse(b)
            rec["warned"] = [str(m.message) for m in w]
            rec["dist"] = _record(res, _np(x), S)
            rec["dist"]["relres"] = float(np.linalg.norm(K @ _np(x) - b) /
                                          np.linalg.norm(b))
        elif name == "structured":
            # 'Structured Apply' "Auto" on the sharded structured apply:
            # f64 GMRES on Stokes-C 32^2, L = 1, full and restarted every
            # 20; CG on Laplace 32^2, L = 2; the IR Newton step, cold and
            # warm, and the IR solve, on the Stokes case
            for tag, run in (
                    ("gmres", lambda dist: _structured_solve(mesh, dist)),
                    ("gmres_restart", lambda dist: _structured_solve(
                        mesh, dist, restart=20)),
                    ("cg", lambda dist: _structured_solve(
                        mesh, dist, "Laplace", 2, "CG")),
                    ("newton", lambda dist: _newton_step(
                        mesh, dist, None, levels=1, structured="Auto")[:3]),
                    ("newton_warm", lambda dist: _structured_ir(
                        mesh, dist, "warm")),
                    ("ir_solve", lambda dist: _structured_ir(
                        mesh, dist, "solve"))):
                S, x, res = run(True)
                Ss = getattr(S, "solver", S)
                rec[tag] = {"dist": _record(res, x),
                            "sharded": Ss._dist_structured is mesh,
                            "halo": Ss._dist is not None}
                if rank0:
                    _, x0, r0 = run(False)
                    rec[tag]["rep"] = _record(r0, x0)
        elif name.startswith("sapply_"):
            rec = sharded_apply(mesh, name)
        elif name == "structured_halo":
            # the deflated and the complex solve with the structured
            # program active: the JAX package takes no structured
            # branch there, so the port takes the halo V-cycle too
            for tag, run in (
                    ("deflated", lambda dist: _deflated_solve(
                        mesh, dist, "Auto")),
                    ("complex", lambda dist: _complex_solve(
                        mesh, dist, False, "Auto"))):
                S, x, res = run(True)[:3]
                rec[tag] = {"dist": _record(res, x),
                            "active": S.precond._structured_active,
                            "halo": S._dist is not None,
                            "sharded": getattr(S, "_dist_structured",
                                               None) is not None}
                if rank0:
                    _, x0, r0 = run(False)[:3]
                    rec[tag]["rep"] = _record(r0, x0)
        elif name == "unshardable":
            # halo plans need levels >= 1: the direct-Schur mode cannot
            # be owner-sharded, so the solver warns and runs replicated
            import warnings
            pd = _solve_params("Laplace", 16, 0, True)
            params = Params(pd)
            K = create_matrix(params)
            P = Preconditioner(K, params, device=mesh.device)
            S = Solver(K, P, params, device=mesh.device)
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                x, res = S.apply_inverse(np.ones(K.shape[0]))
            rec["warned"] = [str(m.message) for m in w]
            rec["dist"] = _record(res, _np(x), S)
            rec["distributed"] = S.distributed
        out[name] = rec
    return out


def structured_solve_params(dist, eq="Stokes-C", levels=1, method="GMRES",
                            restart=None):
    pd = _solve_params(eq, 32, levels, dist, method, maxiter=200)
    pd["Preconditioner"]["Structured Apply"] = "Auto"
    if restart is not None:
        pd["Solver"]["Iterative Solver"]["Num Blocks"] = restart
    return pd


def _structured_solve(mesh, dist, *args, **kw):
    params = Params(structured_solve_params(dist, *args, **kw))
    K = create_matrix(params)
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=mesh.device)
    S = Solver(K, P, params, device=mesh.device)
    x, res = S.apply_inverse(structured_rhs(K))
    return S, _np(x), res


def _structured_ir(mesh, dist, which):
    """The IR solver of the structured Newton step (Stokes-C 32^2,
    L = 1): `newton_step_warm` from the cold factors, or `solve`."""
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    params = Params(mixed_params(dist, None, levels=1, structured="Auto"))
    K = create_matrix(params)
    S = IterativeRefinementSolver(K, params,
                                  testvector=create_testvector(params, K),
                                  device=mesh.device)
    S.compute()
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    if which == "warm":
        res, _ = S.newton_step_warm(S.op64.vals, S.solver.op.vals, b,
                                    S.precond.factors)
        return S, _np(res.x), res
    x = S.solve(b)
    return S, _np(x), S._last_result


def structured_rhs(K):
    """A consistent right-hand side: Stokes-C has a constant-pressure
    null space (tests/test_dist_solve.py:test_dist_structured_solve)."""
    return K @ np.random.default_rng(5).standard_normal(K.shape[0])


# ---------------------------------------------------------------------------
# the sharded structured apply
# ---------------------------------------------------------------------------

def sapply_dict(name):
    """The parameters of a sharded-apply case: Stokes-C on a 2-D
    Cartesian grid (`sapply_<nx>_l<levels>`), or configs/stokes_L2.xml
    (3-D, B-grid transform, separator lengths 4, 4, 8) at 12 x 12 x 8,
    whose level-0 box grid is 1 x 3 x 3 (`sapply_bgrid`)."""
    if name == "sapply_bgrid":
        import os
        from hymls_tpu_torch.config import load_xml
        from hymls_tpu_torch.tools.driver_cases import CONFIGS_DIR
        d = load_xml(os.path.join(CONFIGS_DIR, "stokes_L2.xml")).to_dict()
        d["Problem"]["nx"] = d["Problem"]["ny"] = 12
        return d
    nx, levels = (int(v) for v in name[len("sapply_"):].split("_l"))
    d = precond_params("Stokes-C", nx, levels)
    d["Preconditioner"]["Structured Apply"] = "Auto"
    return d


def sharded_apply(mesh, name):
    """One f64 apply of the structured program sharded over the mesh
    (Preconditioner.sharded_sapply_fn) against the replicated structured
    apply, on the port's own factors; its collectives; and those
    factors (numpy) for the parent to run the JAX package's sharded
    apply on."""
    K, P = build_precond(sapply_dict(name), mesh.device)
    b = torch.as_tensor(np.random.default_rng(7).standard_normal(K.shape[0]),
                        device=mesh.device)
    x_rep = P.apply_inverse(b)
    sapply = P.sharded_sapply_fn(mesh)
    mesh.reset_counters()
    x = sapply(P.factors, b)
    counters = {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in mesh.counters.items()}
    design = P._structured.sharded_apply_fn(mesh)
    rec = {"x": _np(x), "x_rep": _np(x_rep), "b": _np(b),
           "counters": counters, "active": P._structured_active,
           "bgrid": P._bgrid is not None,
           "slabs": [None if sl is None else (sl.ax, sl.sizes)
                     for sl in design.slabs],
           "traffic": design.traffic(x.element_size())}
    if mesh.rank == 0:
        rec["sfactors"] = _np_tree(P.factors.tree)
    return rec


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return _np(t)


def halo_and_gather_vcycle(mesh, dia_cases, vc_cases):
    return halo_dia(mesh, dia_cases), gather_vcycle(mesh, vc_cases)
