"""CPU anchors of chip_smoke.py's phases 18-21: the deflated, complex
and eigenvalue solves at the sizes that script runs on the card, through
the JAX package and through the port on the CPU.

    JAX_PLATFORMS=cpu python tests/_torch_anchors.py [phase ...]

prints one line per case and package (iterations, residuals, counts);
phases are 18, 19, 20, 21a, 21b, 21c (default: all).  The numbers go
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


PHASES = {"18": phase18, "19": phase19, "20": phase20, "21a": phase21a,
          "21b": phase21b, "21c": phase21c}

if __name__ == "__main__":
    for name in sys.argv[1:] or PHASES:
        PHASES[name]()
