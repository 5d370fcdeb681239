"""The port's distributed solves ('Distributed Apply' over a gloo mesh,
hymls_tpu_torch.parallel.dist): GMRES, CG, bordered, deflated, complex
and complex bordered in f64 on 3 ranks take the iterations of the
port's replicated solve and of the JAX package's distributed solve on
a virtual mesh of the same size, and reach what tests/test_dist_solve.py
holds its own solves to; the distributed IR Newton step (all-f32, and
'Factor Precision' 'f64') on 3 and 4 ranks stays within the
ROADMAP's f32 slack of 2 inner iterations of both; an unshardable
configuration warns and solves replicated in both packages."""
import functools

import numpy as np
import pytest
import scipy.sparse as sp

import _torch_parity as TP
import _torch_dist as D

import jax
import jax.numpy as jnp

import hymls_tpu as H
import hymls_tpu.stencils as HS
from hymls_tpu.parallel.mesh import make_mesh, set_mesh

from hymls_tpu_torch.parallel import launch

ALL = ("gmres_l1", "gmres", "cg", "bordered", "deflated", "complex",
       "complex_bordered", "newton", "newton_f64", "unshardable",
       "structured", "bgrid")
NEWTON = ("gmres_l1", "newton", "newton_f64")


@pytest.fixture(scope="module")
def three():
    return launch.run(D.dist_solves, 3, backend="gloo", device="cpu",
                      args=(ALL,), timeout_s=400)[0]


@pytest.fixture(scope="module")
def four():
    return launch.run(D.dist_solves, 4, backend="gloo", device="cpu",
                      args=(NEWTON,), timeout_s=400)[0]


# -- the JAX package's distributed solves, on a virtual mesh of 3 ----------

def _jax_dist(fn, ndev=3):
    set_mesh(make_mesh(ndev))
    try:
        return fn()
    finally:
        set_mesh(None)


def _jax_plain(name):
    method = "CG" if name == "cg" else "GMRES"
    eq, nx, levels = ("Laplace", 32, 1) if name == "gmres_l1" else \
        ("Stokes-C", 32, 2) if name == "gmres" else ("Laplace", 32, 2)
    params = H.Params(D._solve_params(eq, nx, levels, True, method, 60))
    K = HS.create_matrix(params)
    with TP.no_plan_cache():
        P = H.Preconditioner(K, params,
                             testvector=HS.create_testvector(
                                 params, K))
    S = H.Solver(K, P, params)
    b = np.random.default_rng(0).standard_normal(K.shape[0])
    if method == "CG":
        b = K @ b
    x, res = S.apply_inverse(b)
    assert S._dist is not None
    return int(res.iters)


def _jax_bordered():
    params = H.Params(D._solve_params("Stokes-C", 32, 2, True, maxiter=200))
    K = HS.create_matrix(params)
    n = K.shape[0]
    with TP.no_plan_cache():
        P = H.Preconditioner(K, params,
                             testvector=HS.create_testvector(
                                 params, K))
    S = H.Solver(K, P, params)
    V = np.zeros((n, 1))
    V[2::3, 0] = 1.0
    V /= np.linalg.norm(V)
    S.set_border(V)
    x, res = S.apply_inverse(K @ np.random.default_rng(7).standard_normal(n))
    assert S._dist is not None
    return int(res.iters)


def _jax_deflated():
    K = D.aniso_matrix()
    params = H.Params(D.precond_params("Laplace", 32, 2, solver={
        "Krylov Method": "GMRES", "Initial Vector": "Zero",
        "Distributed Apply": True, "Deflated Subspace Dimension": 8,
        "Iterative Solver": {"Maximum Iterations": 100,
                             "Convergence Tolerance": 1e-10}}))
    with TP.no_plan_cache():
        P = H.Preconditioner(K, params,
                             testvector=HS.create_testvector(
                                 params, K)).compute()
    S = H.Solver(K, P, params)
    S.setup_deflation()
    assert S._dist is not None
    x, res = S.apply_inverse(
        K @ np.random.default_rng(5).standard_normal(K.shape[0]))
    return int(res.iters)


def _jax_complex(bordered):
    from hymls_tpu.solvers.complex_solver import ComplexSolver
    A = HS.laplace2d(32, 32)
    n = A.shape[0]
    params = H.Params(D.precond_params("Laplace", 32, 2, solver={
        "Krylov Method": "GMRES", "Distributed Apply": True,
        "Iterative Solver": {"Maximum Iterations": 150 if bordered else 100,
                             "Convergence Tolerance": 1e-10}}))
    with TP.no_plan_cache():
        P = H.Preconditioner(A, params,
                             testvector=HS.create_testvector(
                                 params, A)).compute()
    if bordered:
        B = sp.identity(n, format="csr") * 0.25
        rng = np.random.default_rng(13)
        V = rng.standard_normal((n, 1))
        V /= np.linalg.norm(V)
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        CS = ComplexSolver(A, P, params, B=B).set_border(V)
    else:
        B = sp.identity(n, format="csr") * 0.5
        rng = np.random.default_rng(11)
        z_ex = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        b = A @ z_ex + 1j * (B @ z_ex)
        CS = ComplexSolver(A, P, params, B=B)
    z, res = CS.apply_inverse(b)
    assert CS._dist is not None
    return int(res.iters)


@functools.cache
def _jax_newton(fprec):
    """The JAX package's replicated IR Newton step (its own
    tests/test_dist_solve.py holds the distributed step to this
    count)."""
    from hymls_tpu.solvers.mixed import IterativeRefinementSolver
    params = H.Params(D.mixed_params(False, fprec))
    K = HS.create_matrix(params)
    with TP.no_plan_cache():
        S = IterativeRefinementSolver(
            K, params, testvector=HS.create_testvector(params, K))
    S.compute()
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    fn, dpl, ex, apl = S.newton_step_fn()
    r = jax.device_get(fn(S.op64.vals, S.solver.op.vals, dpl, ex, apl,
                          jnp.asarray(b, jnp.float64)))
    return int(r.iters)


JAX_ITERS = {"gmres_l1": lambda: _jax_plain("gmres_l1"),
             "gmres": lambda: _jax_plain("gmres"),
             "cg": lambda: _jax_plain("cg"),
             "bordered": _jax_bordered, "deflated": _jax_deflated,
             "complex": lambda: _jax_complex(False),
             "complex_bordered": lambda: _jax_complex(True)}


@pytest.mark.parametrize("name", list(JAX_ITERS))
def test_dist_f64_iterations(three, name):
    rec = three[name]
    assert rec["dist"]["dist"], "distributed path did not activate"
    assert rec["dist"]["iters"] == rec["rep"]["iters"]
    assert rec["dist"]["iters"] == _jax_dist(JAX_ITERS[name])


@pytest.mark.parametrize("name", ["gmres_l1", "gmres", "cg"])
def test_dist_plain_solution(three, name):
    """As tests/test_dist_solve.py:53-84: the replicated solve's true
    residual reached, the solution to 1e-6 of its scale (Stokes carries
    a near-null pressure component), the factors from the distributed
    factorization."""
    method = "CG" if name == "cg" else "GMRES"
    eq, nx, levels = ("Laplace", 32, 1) if name == "gmres_l1" else \
        ("Stokes-C", 32, 2) if name == "gmres" else ("Laplace", 32, 2)
    K = TP.problem(D._solve_params(eq, nx, levels, True, method))[0]
    b = np.random.default_rng(0).standard_normal(K.shape[0])
    if method == "CG":
        b = K @ b
    d, r = three[name]["dist"], three[name]["rep"]
    relres = TP.relres(K, d["x"], b)
    relres_ref = TP.relres(K, r["x"], b)
    assert relres <= relres_ref * (1 + 1e-6) + 1e-12
    assert np.abs(d["x"] - r["x"]).max() / np.abs(r["x"]).max() < 1e-6
    assert three[name]["dcompute"]


@pytest.mark.parametrize("name", ["gmres_l1", "gmres", "cg"])
def test_dist_solve_collectives(three, name):
    """Per preconditioner apply one all_gather (the coarse right-hand
    side); besides, one in the distributed factorization and one for
    the solution read-out.  GMRES (right-preconditioned) applies the
    V-cycle once per iteration and once for the update, CG once per
    iteration and once at the start."""
    rec = three[name]
    c = rec["counters"]
    assert c["all_gather"]["calls"] == rec["dist"]["iters"] + 1 + 2
    assert c["ppermute"]["calls"] > 0 and c["psum"]["calls"] > 0


def test_dist_bordered_solution(three):
    d, r = three["bordered"]["dist"], three["bordered"]["rep"]
    scale = np.abs(r["x"]).max()
    assert np.abs(d["x"] - r["x"]).max() / scale < 1e-6
    assert np.abs(d["s"] - r["s"]).max() < 1e-6 * scale


def test_dist_deflated_solution(three):
    d, r = three["deflated"]["dist"], three["deflated"]["rep"]
    x_ex = d["x_ex"]
    assert np.linalg.norm(d["x"] - x_ex) / np.linalg.norm(x_ex) < 1e-7
    assert np.abs(d["x"] - r["x"]).max() / np.abs(r["x"]).max() < 1e-6


@pytest.mark.parametrize("name", ["complex", "complex_bordered"])
def test_dist_complex_solution(three, name):
    d, r = three[name]["dist"], three[name]["rep"]
    assert np.abs(d["x"] - r["x"]).max() / np.abs(r["x"]).max() < 1e-8


def _check_newton(rec, fprec):
    d, r = rec["dist"], rec["rep"]
    assert d["dist"] and d["dcompute"]
    K = TP.problem(D.mixed_params(True, fprec))[0]
    relres = TP.relres(K, d["x"], d["b"])
    relres0 = TP.relres(K, r["x"], d["b"])
    assert relres <= max(relres0 * 1.5, 1e-10)
    assert abs(d["iters"] - r["iters"]) <= 2
    assert abs(d["iters"] - _jax_newton(fprec)) <= 2


@pytest.mark.parametrize("fprec", [None, "f64"])
def test_dist_newton_step_three_ranks(three, fprec):
    _check_newton(three["newton_f64" if fprec else "newton"], fprec)


@pytest.mark.parametrize("fprec", [None, "f64"])
def test_dist_newton_step_four_ranks(four, fprec):
    _check_newton(four["newton_f64" if fprec else "newton"], fprec)
    assert four["gmres_l1"]["dist"]["iters"] == \
        four["gmres_l1"]["rep"]["iters"]


def test_unshardable_warns_and_solves_replicated(three):
    """The direct-Schur mode (L = 0) has no levels to own: both
    packages warn and solve replicated."""
    rec = three["unshardable"]
    assert not rec["distributed"] and not rec["dist"]["dist"]
    assert any("Distributed Apply" in w for w in rec["warned"])
    assert rec["dist"]["relres"] < 1e-8

    def jax_side():
        params = H.Params(D._solve_params("Laplace", 16, 0, True))
        K = HS.create_matrix(params)
        S = H.Solver(K, H.Preconditioner(K, params), params)
        with pytest.warns(UserWarning, match="Distributed Apply"):
            x, res = S.apply_inverse(np.ones(K.shape[0]))
        assert S._dist is None and not S.distributed
        return int(res.iters)
    assert _jax_dist(jax_side) == rec["dist"]["iters"]


def test_structured_apply_with_a_mesh_raises(three):
    """'Structured Apply' "Auto" with the structured program active and
    a mesh: where the JAX package shards the structured apply
    (solvers/solver.py:160-180, mixed.py:139-155), the port raises; it
    never quietly runs another apply."""
    rec = three["structured"]
    assert rec["active"] == [True, True]
    for tag in ("solver", "newton"):
        assert rec[tag] is not None and "sharded structured apply" in \
            rec[tag] and "M12" in rec[tag], tag


def test_bgrid_transform_warns_and_solves_replicated(three):
    """configs/stokes_L2.xml at 8^3 with the B-grid transform: the
    preconditioner holds T'KT, so the port does not distribute it; it
    warns and takes the replicated solve (54 iterations, as without a
    mesh), where the JAX package's distributed solve returns NaN
    (ROADMAP Queue 3)."""
    rec = three["bgrid"]
    assert not rec["dist"]["dist"]
    assert any("B-grid transform is not distributed" in w
               for w in rec["warned"])
    assert rec["dist"]["iters"] == 54 and rec["dist"]["relres"] < 1e-8
