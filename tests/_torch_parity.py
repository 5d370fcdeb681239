"""Shared helpers of the tests that hold `hymls_tpu_torch` against the
JAX package on the CPU: both preconditioners from the same `Params`
dict, matrix and test vector, and the comparisons the ROADMAP defines
(identical plans; factors to 1e-10 relative in f64; equal M^{-1} b)."""
import contextlib
import os
import shutil
import time

import numpy as np

import jax.numpy as jnp
import torch

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu_torch.convert import plans_from_numpy
from hymls_tpu_torch.stencils import create_matrix, create_testvector

LEVEL_KEYS = ("A11inv", "G", "A21", "blkinv", "sc")

# The tests run at small sizes, usually in several worker processes side
# by side: one intra-op thread each, or the workers' thread pools fight
# over the cores and the many small tensor ops of a Krylov loop take
# ten times as long.  Collection imports this module before any test
# runs, so the setting holds for the whole process.
torch.set_num_threads(1)


def await_native_planners(timeout=120.0):
    """Load both packages' native plan builders, waiting for a complete
    library where another process is still writing it.

    Each package compiles native/_planner.so with g++ at first use, in
    place.  Under pytest-xdist several workers do so at once, and a
    worker that loads the file while another's g++ still writes it
    falls back to the Python planner for the rest of its life.  That
    planner orders the plan maps differently (equivalent plans, not
    identical ones), so a reference built on it fails every "identical
    plans" comparison.  Collection imports this module in every worker
    before any test runs, so the wait happens once per worker, before
    either package builds a plan."""
    if shutil.which("g++") is None:
        return          # no compiler: both packages take the fallback
    import hymls_tpu.native as ref_native
    import hymls_tpu_torch.native as port_native
    deadline = time.monotonic() + timeout
    for mod in (ref_native, port_native):
        while mod.planner() is None and time.monotonic() < deadline:
            mod._PLANNER_TRIED = False      # load again once written
            time.sleep(0.5)


await_native_planners()


@contextlib.contextmanager
def no_plan_cache():
    """The reference without its plan disk cache: it stores every plan
    build slower than 5 s in a directory shared by all processes, and
    its key does not say which planner (native or Python) built the
    plan, so a loaded machine could hand one worker another's
    differently ordered plans.  The empty string turns the cache off
    (hymls_tpu/core/preconditioner.py:_plan_cache_key)."""
    old = os.environ.get("HYMLS_PLAN_CACHE")
    os.environ["HYMLS_PLAN_CACHE"] = ""
    try:
        yield
    finally:
        if old is None:
            del os.environ["HYMLS_PLAN_CACHE"]
        else:
            os.environ["HYMLS_PLAN_CACHE"] = old


def rel(ref, got, floor=1e-300):
    """max|ref - got| over max(max|ref|, floor); 0 for empty arrays."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), floor))


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [np_tree(v) for v in t]
    return np.asarray(t)


def problem(d, make_K=None):
    """(K, test vector) of the parameter dict `d`."""
    K = (make_K() if make_K else create_matrix(T.Params(d))).tocsr()
    return K, create_testvector(T.Params(d), K)


def pair(d, K, tv, dtype=torch.float64, d_ref=None, compute=True):
    """(reference, port) preconditioners of the same problem; `d_ref`
    where the reference needs other parameters than the port."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with no_plan_cache():
        Pj = H.Preconditioner(K, H.Params(d_ref or d), testvector=tv,
                              dtype=jdt)
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv, dtype=dtype,
                          device="cpu")
    if compute:
        Pj.compute()
        Pt.compute()
    return Pj, Pt


def assert_plans_identical(Pj, Pt):
    """Every level's device plan (the split maps included, where both
    carry them), and the coarse plan where there is one."""
    levels, coarse = plans_from_numpy(
        np_tree(Pj._dplans),
        None if Pj.coarse_plan is None else np_tree(Pj._dcoarse),
        device="cpu")
    assert len(levels) == len(Pt._dplans)
    for a, b in zip(levels, Pt._dplans):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k].to(b[k].dtype), b[k]), k
    assert (coarse is None) == (Pt._dcoarse is None)
    for k in coarse or ():
        assert torch.equal(coarse[k], Pt._dcoarse[k]), k
    assert [p.apply_ot for p in Pj.plans] == [p.apply_ot for p in Pt.plans]


def assert_factors_agree(Pj, Pt, tol=1e-10, scale=None):
    """Per-level factors and the coarse factor, to `tol` relative to
    each tensor's own maximum, or to `scale` where that is larger
    (assembled values that are zero up to rounding)."""
    fj, ft = Pj._factors, Pt._factors
    assert len(fj["levels"]) == len(ft["levels"])
    for lev, (a, b) in enumerate(zip(fj["levels"], ft["levels"])):
        assert set(a) == set(b)
        for key in LEVEL_KEYS:
            if key in b:
                err = rel(a[key], b[key].numpy(), floor=scale or 1e-300)
                assert err <= tol, f"level {lev} {key}: {err:.2e}"
    assert set(fj["coarse"]) == set(ft["coarse"])
    for key in ("inv", "lu"):
        if key in ft["coarse"]:
            err = rel(fj["coarse"][key], ft["coarse"][key].numpy())
            assert err <= tol, f"coarse {key}: {err:.2e}"


# -- the driver: the gate of tests/test_torch_driver.py and test_torch_suite.py

# relres / relerr of both packages agree to this, relative, ...
AGREE = 1e-8
# ... plus this, absolute: the rounding of an f64 residual
FLOOR = 1e-13


def _agree(a, b, tol=AGREE):
    return abs(a - b) <= tol * max(abs(a), abs(b)) + FLOOR


def assert_same_solves(rj, rt, tol_relres=AGREE, tol_relerr=AGREE):
    """Two driver RunReports: both passed their 'Targets', the same
    number of solves, each converged in the same iterations, relres and
    relerr agreeing to `tol_*` relative plus FLOOR."""
    assert rt.passed, rt.failures
    assert rj.passed, rj.failures
    assert len(rj.solves) == len(rt.solves) > 0
    for sj, st in zip(rj.solves, rt.solves):
        assert st.iters == sj.iters
        assert st.converged and sj.converged
        assert _agree(sj.relres, st.relres, tol_relres), (sj.relres,
                                                          st.relres)
        assert _agree(sj.relerr, st.relerr, tol_relerr), (sj.relerr,
                                                          st.relerr)


def solve_both(d, K, Pj, Pt, b, d_ref=None):
    """f64 Krylov solves of K x = b through both packages' `Solver`;
    returns ((x, result) of the reference, (x, result) of the port)."""
    xj, rj = H.Solver(K, Pj, H.Params(d_ref or d)).apply_inverse(b)
    xt, rt = T.Solver(K, Pt, T.Params(d), device="cpu").apply_inverse(b)
    return (np.asarray(xj), rj), (xt.numpy(), rt)


def relres(K, x, b):
    return float(np.linalg.norm(K @ np.asarray(x) - b) / np.linalg.norm(b))


# -- the solver family (deflated, complex and eigenvalue solves) -----------

def laplace_cfg(nx, levels=2, maxiter=100, tol=1e-10, solver=None,
                drv=None):
    """The parameter dict of tests/test_variants.py's `_params` and
    tests/test_combos.py's `_neumann_setup`."""
    slv = {"Krylov Method": "GMRES", "Initial Vector": "Zero",
           "Iterative Solver": {"Maximum Iterations": maxiter,
                                "Convergence Tolerance": tol}}
    slv.update(solver or {})
    return {"Problem": {"Equations": "Laplace", "Dimension": 2,
                        "nx": nx, "ny": nx},
            "Driver": dict(drv or {}),
            "Solver": slv,
            "Preconditioner": {"Separator Length": 4,
                               "Number of Levels": levels}}


def aniso_laplace(nx, eps=0.01):
    """The anisotropic Laplace of tests/test_variants.py's deflated
    solve."""
    from hymls_tpu_torch.stencils.generators import _cross2d
    return (-_cross2d(nx, nx, 2 + 2 * eps, -1.0, -1.0, -eps, -eps)).tocsr()


def neumann_setup(nx=32, levels=2, solver=None):
    """(dict, K, test vector, constant null space) of the Neumann
    Laplace of tests/test_combos.py."""
    from hymls_tpu_torch.stencils import laplace2d_neumann, create_nullspace
    d = laplace_cfg(nx, levels, solver=solver,
                    drv={"Null Space Type": "Constant"})
    K = laplace2d_neumann(nx, nx).tocsr()
    return d, K, create_testvector(T.Params(d), K), \
        create_nullspace(T.Params(d), K.shape[0])


def solver_pair(d, K, tv=None, border=None):
    """(reference, port) f64 `Solver`s on computed preconditioners of
    the same problem, the border set on both before the factorization."""
    Pj, Pt = pair(d, K, tv, compute=False)
    Sj = H.Solver(K, Pj, H.Params(d))
    St = T.Solver(K, Pt, T.Params(d), device="cpu")
    if border is not None:
        Sj.set_border(border)
        St.set_border(border)
    Pj.compute()
    Pt.compute()
    return Sj, St


def projector_gap(Va, Vb):
    """max |Va Va' - Vb Vb'|: two orthonormal blocks compared as
    subspaces (QR column signs differ between libraries)."""
    Va, Vb = np.asarray(Va), np.asarray(Vb)
    return float(np.abs(Va @ Va.T - Vb @ Vb.T).max())
