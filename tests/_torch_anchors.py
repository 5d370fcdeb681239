"""CPU anchors of chip_smoke.py's phases 18-22, 25 and 26: the deflated,
complex and eigenvalue solves, the driver's configs and the distributed
solves (the halo V-cycle's and the sharded structured apply's) at the
sizes that script runs on the card, through the JAX package and through
the port on the CPU.

    JAX_PLATFORMS=cpu python tests/_torch_anchors.py [phase ...]

prints one line per case and package (iterations, residuals, counts);
phases are 18, 19, 20, 21a, 21b, 21c, 22, 25, 26 (default: all).  Phases
25 and 26 run the JAX package on a virtual mesh of 4 CPU devices and the
port on 4 gloo ranks (parallel/launch.run).  The numbers go
into chip_smoke.py's ANCHOR_* constants and PERF.md section 4.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (pins JAX to the CPU)
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import scipy.sparse.linalg as spla  # noqa: E402

import hymls_tpu as H  # noqa: E402
import hymls_tpu_torch as T  # noqa: E402
from hymls_tpu.solvers.complex_solver import ComplexSolver as JCS  # noqa: E402
from hymls_tpu.solvers.eigen import JDQR as JJDQR  # noqa: E402
from hymls_tpu.solvers.eigen import shift_invert_eigs as jsie  # noqa: E402
from hymls_tpu_torch.solvers.complex_solver import ComplexSolver  # noqa: E402
from hymls_tpu_torch.solvers.eigen import JDQR, shift_invert_eigs  # noqa: E402
from hymls_tpu_torch.stencils import create_testvector, laplace2d  # noqa: E402
from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian  # noqa: E402

from _torch_parity import (aniso_laplace, laplace_cfg, neumann_setup,  # noqa: E402
                           pair, relres, solver_pair)

NX = 128


def both(fn):
    """fn("jax") and fn("port"), each timed and printed."""
    for which in ("jax", "port"):
        t0 = time.perf_counter()
        out = fn(which)
        print(f"  {which:4s} {out}  [{time.perf_counter() - t0:.1f} s]",
              flush=True)


def to_np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def phase18():
    print(f"18 deflated: anisotropic Laplace {NX}^2, L=2, tol 1e-10, "
          f"maxiter 300")
    K = aniso_laplace(NX)
    b = K @ np.random.default_rng(5).standard_normal(K.shape[0])
    for k in (8, 0):
        d = laplace_cfg(NX, maxiter=300,
                        solver={"Deflated Subspace Dimension": k})
        S = dict(zip(("jax", "port"), solver_pair(
            d, K, create_testvector(T.Params(d), K))))

        def run(which):
            s = S[which]
            s.setup_deflation()
            x, res = s.apply_inverse(b)
            info = getattr(s, "_defl_info", {})
            return (f"k={k}: {int(res.iters)} iterations, relres "
                    f"{relres(K, to_np(x), b):.2e}, {info}")
        both(run)


def phase19():
    print(f"19 bordered + deflated: Neumann Laplace {NX}^2, L=2, k=6")
    d, K, tv, ns = neumann_setup(
        NX, solver={"Deflated Subspace Dimension": 6,
                    "Iterative Solver": {"Maximum Iterations": 300,
                                         "Convergence Tolerance": 1e-10}})
    x_ex = np.random.default_rng(3).standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex
    S = dict(zip(("jax", "port"), solver_pair(d, K, tv, border=ns)))

    def run(which):
        s = S[which]
        s.setup_deflation()
        x, res = s.apply_inverse(b)
        x = to_np(x)
        return (f"{int(res.iters)} iterations, relres "
                f"{relres(K, x, b):.2e}, error "
                f"{np.linalg.norm(x - x_ex) / np.linalg.norm(x_ex):.2e}, "
                f"{s._defl_info}")
    both(run)
    d0 = {**d, "Solver": {**d["Solver"], "Deflated Subspace Dimension": 0}}
    S0 = dict(zip(("jax", "port"), solver_pair(d0, K, tv, border=ns)))
    both(lambda w: f"k=0: {int(S0[w].apply_inverse(b)[1].iters)} iterations")


def phase20():
    print(f"20 complex: (A + 0.5 i I) z = b, Laplace {NX}^2, L=1")
    A = laplace2d(NX, NX).tocsr()
    B = sp.identity(A.shape[0], format="csr") * 0.5
    d = laplace_cfg(NX, levels=1, maxiter=300)
    Pj, Pt = pair(d, A, create_testvector(T.Params(d), A))
    rng = np.random.default_rng(11)
    z_ex = rng.standard_normal(A.shape[0]) + 1j * rng.standard_normal(
        A.shape[0])
    b = A @ z_ex + 1j * (B @ z_ex)
    CS = {"jax": JCS(A, Pj, H.Params(d), B=B),
          "port": ComplexSolver(A, Pt, T.Params(d), B=B, device="cpu")}

    def run(which):
        z, res = CS[which].apply_inverse(b)
        z = to_np(z)
        return (f"{int(res.iters)} iterations, converged "
                f"{bool(res.converged)}, error "
                f"{np.linalg.norm(z - z_ex) / np.linalg.norm(z_ex):.2e}")
    both(run)
    S = {"jax": H.Solver(A, Pj, H.Params(d)),
         "port": T.Solver(A, Pt, T.Params(d), device="cpu")}
    both(lambda w: f"real f64 solve of A x = Re b: "
                   f"{int(S[w].apply_inverse(b.real)[1].iters)} iterations")

    print(f"20 complex bordered: Neumann Laplace {NX}^2 + 0.3 i I, L=1")
    d, K, tv, ns = neumann_setup(
        NX, levels=1, solver={"Iterative Solver": {
            "Maximum Iterations": 300, "Convergence Tolerance": 1e-10}})
    B = sp.identity(K.shape[0], format="csr") * 0.3
    Pj, Pt = pair(d, K, tv, compute=False)
    CS = {"jax": JCS(K, Pj, H.Params(d), B=B),
          "port": ComplexSolver(K, Pt, T.Params(d), B=B, device="cpu")}
    for cs in CS.values():
        cs.set_border(ns)
    rng = np.random.default_rng(5)
    z_ex = rng.standard_normal(K.shape[0]) + 1j * rng.standard_normal(
        K.shape[0])
    z_ex -= ns @ (ns.T.conj() @ z_ex)
    b = K @ z_ex + 1j * (B @ z_ex)

    def run_b(which):
        z, res = CS[which].apply_inverse(b)
        z = to_np(z)
        r = np.linalg.norm(K @ z + 1j * (B @ z) - b) / np.linalg.norm(b)
        return (f"{int(res.iters)} iterations, converged "
                f"{bool(res.converged)}, relres {r:.2e}")
    both(run_b)


def eig_cfg(nx, equations="Laplace", **eig):
    e = {"How Many": 10, "Which": "SM", "Convergence Tolerance": 1e-8,
         "Number of Iterations": 100, "Maximum Subspace Dimension": 40,
         "Restart Dimension": 20, **eig}
    d = laplace_cfg(nx, levels=1, drv={"Eigenvalues": e})
    d["Problem"]["Equations"] = equations
    return d


def jdqr_both(K, d):
    Pj, Pt = pair(d, K, None)
    J = {"jax": lambda: JJDQR(K, None, Pj, H.Params(d)),
         "port": lambda: JDQR(K, None, Pt, T.Params(d), device="cpu")}

    def run(which):
        jd = J[which]()
        r = jd.solve()
        resid = max((np.linalg.norm(K @ r.vectors[:, j] -
                                    r.values[j] * r.vectors[:, j])
                     for j in range(r.converged)), default=0.0)
        return (f"{r.converged} converged in {r.iterations} outer "
                f"iterations, max residual {resid:.1e}, corrections "
                f"{getattr(jd, 'corrections', None)}, values "
                f"{np.array2string(np.asarray(r.values), precision=10)}")
    both(run)


def phase21a():
    print("21a JDQR: Laplace 64^2, 10 smallest, tol 1e-8, subspace 40/20")
    jdqr_both(laplace2d(64, 64).tocsr(), eig_cfg(64))


def phase21b():
    for nx in (16, 32, 64):
        print(f"21b JDQR: cavity Jacobian {nx}^2 Re 1000, 4 SM, tol 1e-6")
        jdqr_both(cavity_jacobian(nx, nx, re=1000.0).tocsr(),
                  eig_cfg(nx, "Stokes-C", **{
                      "How Many": 4, "Convergence Tolerance": 1e-6,
                      "Number of Iterations": 80,
                      "Maximum Subspace Dimension": 30,
                      "Restart Dimension": 12}))


def phase21c():
    print("21c shift-invert: Laplace 64^2, 10 values around 0, tol 1e-10")
    K = laplace2d(64, 64).tocsr()
    d = eig_cfg(64)
    Pj, Pt = pair(d, K, None)
    ref = np.sort(np.abs(np.real(spla.eigs(
        K.asfptype(), k=10, sigma=0, which="LM",
        return_eigenvectors=False))))
    S = {"jax": (jsie, H.Solver(K, Pj, H.Params(d))),
         "port": (shift_invert_eigs, T.Solver(K, Pt, T.Params(d),
                                              device="cpu"))}

    def run(which):
        fn, s = S[which]
        solves = [0]
        orig = s.apply_inverse

        def counted(b):
            solves[0] += 1
            return orig(b)
        s.apply_inverse = counted
        r = fn(K, None, s, k=10, target=0.0, tol=1e-10)
        got = np.sort(np.abs(np.real(r.values)))
        return (f"max |lambda - scipy| {np.abs(got - ref).max():.1e}, "
                f"{solves[0]} inner solves")
    both(run)


def phase22():
    """chip_smoke.py phase 22: the driver's configs at their own sizes
    and refinement depths."""
    import hymls_tpu.driver as HD
    import hymls_tpu.solvers.eigen as HE
    import hymls_tpu_torch.driver as TD
    import hymls_tpu_torch.solvers.eigen as TE
    from hymls_tpu.config import load_xml as jload
    from hymls_tpu_torch.config import load_xml as tload
    from hymls_tpu_torch.tools.driver_cases import (DRIVER_CONFIGS,
                                                    driver_params,
                                                    eigen_results)
    mods = {"jax": (HD, HE, jload, {}),
            "port": (TD, TE, tload, {"device": "cpu"})}
    for name in DRIVER_CONFIGS:
        print(f"22 driver: configs/{name}.xml, full depth")

        def run(which):
            drv, eig, load, kw = mods[which]
            with eigen_results(eig) as got:
                reps = drv.run_with_refinements(driver_params(load, name),
                                                **kw)
            outer = [r.iterations for r in got]
            return (f"iterations {[[s.iters for s in r.solves] for r in reps]}"
                    f", max relres {max(s.relres for r in reps for s in r.solves):.2e}"
                    f", passed {all(r.passed for r in reps)}"
                    f"{f', JDQR outer {outer}' if outer else ''}")
        both(run)


def phase25(ndev=4):
    """The distributed solves of chip_smoke.py phase 25 (a-c), at ndev
    ranks; hymls_tpu_torch/tools/dist_cases.py holds the cases."""
    from hymls_tpu.parallel.mesh import make_mesh, set_mesh
    from hymls_tpu.solvers.mixed import IterativeRefinementSolver as JIR
    from hymls_tpu_torch.parallel import launch
    from hymls_tpu_torch.stencils import create_nullspace
    from hymls_tpu_torch.tools import dist_cases as dc
    import jax
    import jax.numpy as jnp

    def jax_newton(K, b, d):
        params = H.Params(d)
        S = JIR(K, params, testvector=create_testvector(params, K))
        S.compute()
        fn, dpl, ex, apl = S.newton_step_fn()
        r = jax.device_get(fn(S.op64.vals, S.solver.op.vals, dpl, ex, apl,
                              jnp.asarray(b, jnp.float64)))
        return (f"{int(r.iters)} inner iterations, relres "
                f"{relres(K, np.asarray(r.x), b):.2e}, distributed "
                f"{S._dist is not None}")

    def jax_solver(K, d, b, border=None):
        params = H.Params(d)
        P = H.Preconditioner(K, params,
                             testvector=create_testvector(params, K))
        S = H.Solver(K, P, params)
        if border is not None:
            S.set_border(border)
        x, res = S.apply_inverse(b)
        return (f"{int(res.iters)} iterations, relres "
                f"{relres(K, np.asarray(x), b):.2e}, distributed "
                f"{S._dist is not None}")

    def jax_deflated():
        K, b = dc.aniso_matrix()
        params = H.Params(dc.laplace_dict(
            2, True, solver={"Deflated Subspace Dimension": 8}))
        P = H.Preconditioner(K, params,
                             testvector=create_testvector(params, K)).compute()
        S = H.Solver(K, P, params)
        S.setup_deflation()
        x, res = S.apply_inverse(b)
        return (f"{int(res.iters)} iterations, relres "
                f"{relres(K, np.asarray(x), b):.2e}, distributed "
                f"{S._dist is not None}")

    def jax_complex():
        A, B, b, z_ex = dc.complex_case()
        params = H.Params(dc.laplace_dict(1, True))
        P = H.Preconditioner(A, params,
                             testvector=create_testvector(params, A)).compute()
        CS = JCS(A, P, params, B=B)
        z, res = CS.apply_inverse(b)
        z = np.asarray(z)
        return (f"{int(res.iters)} iterations, error "
                f"{np.linalg.norm(z - z_ex) / np.linalg.norm(z_ex):.2e}, "
                f"distributed {CS._dist is not None}")

    K, b = dc.cavity64_matrix()
    K128, b128 = dc.stokes128_matrix(T.Params)
    ns = create_nullspace(T.Params(dc.bordered_dict()), K.shape[0])
    jax_cases = {
        "a cavity64 IR newton_step": lambda: jax_newton(
            K, b, dc.cavity64_dict(True)),
        "b stokes128_L2 IR newton_step": lambda: jax_newton(
            K128, b128, dc.cavity64_dict(True, 2, 128)),
        "c gmres_cavity64": lambda: jax_solver(K, dc.cavity64_dict(True),
                                               b),
        "c bordered_cavity64": lambda: jax_solver(
            K, dc.bordered_dict(True), dc.bordered_rhs(K, ns), border=ns),
        "c deflated_aniso128": jax_deflated,
        "c complex128": jax_complex}
    print(f"25 distributed: the JAX package on {ndev} virtual CPU devices")
    set_mesh(make_mesh(ndev))
    try:
        for name, fn in jax_cases.items():
            t0 = time.perf_counter()
            print(f"  jax  {name}: {fn()}  "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    finally:
        set_mesh(None)
    print(f"25 distributed: the port on {ndev} gloo CPU ranks")
    t0 = time.perf_counter()
    out = launch.run(dc.phase25, ndev, backend="gloo", device="cpu",
                     args=(("a", "b", "c"),), timeout_s=3000)[0]
    for part, tag in (("a", "cavity64 IR newton_step"),
                      ("b", "stokes128_L2 IR newton_step")):
        for side in ("dist", "rep"):
            r = out[part][side]
            print(f"  port {part} {tag} {side}: {r['iters']} inner "
                  f"iterations, relres {r['relres']:.2e}")
    for side in ("dist", "rep"):
        for name, r in out["c"][side].items():
            print(f"  port c {name} {side}: {r}")
    print(f"  [{time.perf_counter() - t0:.1f} s]")


def phase26(ndev=4):
    """The sharded structured IR Newton steps of chip_smoke.py phase 26
    (a, b), at ndev ranks, each beside the replicated step;
    hymls_tpu_torch/tools/dist_cases.py holds the cases."""
    from hymls_tpu.parallel.mesh import make_mesh, set_mesh
    from hymls_tpu.solvers.mixed import IterativeRefinementSolver as JIR
    from hymls_tpu_torch.parallel import launch
    from hymls_tpu_torch.tools import dist_cases as dc
    import jax
    import jax.numpy as jnp

    def jax_newton(K, b, d):
        params = H.Params(d)
        S = JIR(K, params, testvector=create_testvector(params, K))
        S.compute()
        fn, dpl, ex, apl = S.newton_step_fn()
        r = jax.device_get(fn(S.op64.vals, S.solver.op.vals, dpl, ex, apl,
                              jnp.asarray(b, jnp.float64)))
        return (f"{int(r.iters)} inner iterations, relres "
                f"{relres(K, np.asarray(r.x), b):.2e}, sharded structured "
                f"{getattr(S, '_dist_structured', None) is not None}")

    K, b = dc.cavity64_matrix()
    K128, b128 = dc.stokes128_matrix(T.Params)
    cases = {"a cavity64 IR newton_step": (K, b, lambda dist: dc.cavity64_dict(
                 dist, structured="Auto")),
             "b stokes128_L2 IR newton_step": (K128, b128, lambda dist:
                 dc.cavity64_dict(dist, 2, 128, structured="Auto"))}
    print(f"26 sharded structured: the JAX package, replicated and on "
          f"{ndev} virtual CPU devices")
    for name, (KK, bb, dict_of) in cases.items():
        for dist in (False, True):
            t0 = time.perf_counter()
            set_mesh(make_mesh(ndev) if dist else None)
            try:
                out = jax_newton(KK, bb, dict_of(dist))
            finally:
                set_mesh(None)
            print(f"  jax  {name} {'dist' if dist else 'rep '}: {out}  "
                  f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    print(f"26 sharded structured: the port on {ndev} gloo CPU ranks")
    t0 = time.perf_counter()
    out = launch.run(dc.phase26, ndev, backend="gloo", device="cpu",
                     timeout_s=3000)
    for part, tag in (("a", "cavity64 IR newton_step"),
                      ("b", "stokes128_L2 IR newton_step")):
        for side in ("dist", "rep"):
            r = out[0][part][side]
            print(f"  port {part} {tag} {side}: {r['iters']} inner "
                  f"iterations, relres {r['relres']:.2e}"
                  + (f", sharded {r['sharded']}, halo {r['dist_active']}, "
                     f"all ranks {[o[part]['dist']['iters'] for o in out]}"
                     if side == "dist" else ""))
    for c in out[0]["c"]:
        print(f"  port c {c['name']}: sharded apply vs replicated "
              f"{c['apply_rel']:.2e} (exact {c['apply_exact']}), slabs "
              f"{c['slabs']}, per apply {c['per_apply']}, design "
              f"{c['design']}")
    print(f"  [{time.perf_counter() - t0:.1f} s]")


PHASES = {"18": phase18, "19": phase19, "20": phase20, "21a": phase21a,
          "21b": phase21b, "21c": phase21c, "22": phase22, "25": phase25,
          "26": phase26}

if __name__ == "__main__":
    for name in sys.argv[1:] or PHASES:
        PHASES[name]()
