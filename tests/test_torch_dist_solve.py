"""The port's distributed solves ('Distributed Apply' over a gloo mesh,
hymls_tpu_torch.parallel.dist): GMRES, CG, bordered, deflated, complex
and complex bordered in f64 on 3 ranks take the iterations of the
port's replicated solve and of the JAX package's distributed solve on
a virtual mesh of the same size, and reach what tests/test_dist_solve.py
holds its own solves to; the distributed IR Newton step (all-f32, and
'Factor Precision' 'f64') on 3 and 4 ranks stays within the
ROADMAP's f32 slack of 2 inner iterations of both; an unshardable
configuration warns and solves replicated in both packages.  With the
structured program active ('Structured Apply' "Auto") both packages
shard the structured apply over the mesh: one apply against the
replicated one and the JAX package's sharded apply on the same factors
(1e-12 relative, f64), its collectives, and GMRES and the IR Newton
step on it against the replicated solves and the JAX package's
distributed structured solves on a virtual mesh of the same size."""
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

# the sharded structured apply's cases on 3 ranks (tests/_torch_dist.py
# sapply_dict) and on 4
SAPPLY3 = ("sapply_32_l1", "sapply_64_l2", "sapply_bgrid")
SAPPLY4 = ("sapply_32_l2",)
ALL = ("gmres_l1", "gmres", "cg", "bordered", "deflated", "complex",
       "complex_bordered", "newton", "newton_f64", "unshardable",
       "structured", "bgrid", "structured_halo") + SAPPLY3
NEWTON = ("gmres_l1", "newton", "newton_f64") + SAPPLY4


@pytest.fixture(scope="module")
def three_ranks():
    return launch.run(D.dist_solves, 3, backend="gloo", device="cpu",
                      args=(ALL,), timeout_s=400)


@pytest.fixture(scope="module")
def three(three_ranks):
    return three_ranks[0]


@pytest.fixture(scope="module")
def four_ranks():
    return launch.run(D.dist_solves, 4, backend="gloo", device="cpu",
                      args=(NEWTON,), timeout_s=400)


@pytest.fixture(scope="module")
def four(four_ranks):
    return four_ranks[0]


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


@pytest.mark.parametrize("fprec", [None, "f64"])
def test_dist_newton_step_takes_the_replicated_passes(three_ranks, fprec):
    """The one refinement loop in its two layouts: the owner-sharded
    Newton step on 3 ranks takes, on every rank, as many f64 refinement
    passes as the replicated step, each to the f64 gate of
    `_check_newton`."""
    name = "newton_f64" if fprec else "newton"
    r = three_ranks[0][name]["rep"]
    assert r["passes"] >= 1
    for o in three_ranks:
        assert o[name]["dist"]["passes"] == r["passes"]
    K = TP.problem(D.mixed_params(True, fprec))[0]
    b = three_ranks[0][name]["dist"]["b"]
    assert TP.relres(K, r["x"], b) <= 1e-10
    assert TP.relres(K, three_ranks[0][name]["dist"]["x"], b) <= \
        max(TP.relres(K, r["x"], b) * 1.5, 1e-10)


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


# -- the sharded structured apply ------------------------------------------

def _jax_tree(t):
    """The port's factor tree (numpy leaves) as the JAX package's: LU
    pivots from torch's 1-based int32 to JAX's 0-based swap indices."""
    if isinstance(t, dict):
        return {k: jnp.asarray(np.asarray(v) - 1) if k == "piv"
                else _jax_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_jax_tree(v) for v in t]
    return jnp.asarray(t)


def _jax_sharded_apply(name, rec, ndev):
    """The JAX package's sharded structured apply on a virtual mesh of
    `ndev` (StructuredProgram.sharded_apply_fn; with the B-grid
    transform Preconditioner.sharded_sapply_fn) on the port's factors
    and right-hand side."""
    params = H.Params(D.sapply_dict(name))
    K = HS.create_matrix(params)
    with TP.no_plan_cache():
        Pj = H.Preconditioner(K, params,
                              testvector=HS.create_testvector(params, K))
    assert Pj._structured_active
    mesh = make_mesh(ndev)
    consts = Pj._structured.consts
    if Pj._bgrid_T is not None:
        fn = jax.jit(Pj.sharded_sapply_fn(mesh))
        args = (_jax_tree(rec["sfactors"]), consts, jnp.asarray(rec["b"]))
    else:
        apply_sh = Pj._structured.sharded_apply_fn(mesh)
        fn = jax.jit(lambda f, c, b: apply_sh(f, b, c))
        args = (_jax_tree(rec["sfactors"]), consts, jnp.asarray(rec["b"]))
    with mesh:
        return np.asarray(fn(*args))


# per case: the split of each level (axis, slab sizes; None where the
# level stays whole on every rank) and one apply's ppermute and
# all_gather calls on every rank: per sharded level one ppermute for the
# one shift along J (-1) of its roll offsets on the way down and one in
# the back-substitution, and two all_gathers (the Vsum right-hand side,
# the output)
SAPPLY_DESIGN = {
    "sapply_32_l1": ([(1, (3, 3, 2))], 2, 2),
    "sapply_64_l2": ([(1, (6, 5, 5)), (1, (2, 1, 1))], 4, 4),
    "sapply_bgrid": ([(1, (1, 1, 1)), None], 2, 2),
    "sapply_32_l2": ([(1, (2, 2, 2, 2)), None], 2, 2)}


def _check_sharded_apply(ranks, name):
    recs = [o[name] for o in ranks]
    r0 = recs[0]
    assert r0["active"]
    assert r0["bgrid"] == (name == "sapply_bgrid")
    slabs, n_pp, n_ag = SAPPLY_DESIGN[name]
    scale = np.abs(r0["x_rep"]).max()
    for rec in recs:
        assert [None if sl is None else (sl[0], tuple(sl[1]))
                for sl in rec["slabs"]] == slabs
        # the output is replicated: every rank holds the same bytes
        np.testing.assert_array_equal(rec["x"], r0["x"])
        assert np.abs(rec["x"] - rec["x_rep"]).max() <= 1e-12 * scale
        c = rec["counters"]
        assert c["ppermute"]["calls"] == n_pp
        assert c["all_gather"]["calls"] == n_ag
        assert c["psum"]["calls"] == 0
        # and the bytes ShardedApply.traffic states
        for prim in ("ppermute", "all_gather"):
            assert c[prim] == rec["traffic"][prim], prim
        # only the sharded levels exchange planes
        assert set(c["ppermute_words"]) == {
            f"sapply{lev}" for lev, sl in enumerate(slabs) if sl}
    x_jax = _jax_sharded_apply(name, r0, len(recs))
    assert np.abs(r0["x"] - x_jax).max() <= 1e-12 * np.abs(x_jax).max()


@pytest.mark.parametrize("name", SAPPLY3)
def test_sharded_structured_apply_three_ranks(three_ranks, name):
    """Stokes-C 32^2, L = 1 (box grid 8 x 8 split 3/3/2 along J),
    64^2, L = 2 (16 x 16 and 4 x 4, both split), and configs/
    stokes_L2.xml at 12 x 12 x 8 with the B-grid transform (T' before
    and T after the sharded apply; level 1's 2 x 2 stays whole): the
    sharded apply against the replicated structured apply and the JAX
    package's sharded apply on a virtual mesh of 3, 1e-12 relative."""
    _check_sharded_apply(three_ranks, name)


def test_sharded_structured_apply_small_level_stays_whole(four_ranks):
    """Stokes-C 32^2, L = 2 on 4 ranks: level 1's 2 x 2 box grid holds
    fewer boxes along its largest axis than there are ranks, so it runs
    whole on every rank and exchanges no planes."""
    _check_sharded_apply(four_ranks, "sapply_32_l2")


def _jax_structured_gmres():
    pd = D._solve_params("Stokes-C", 32, 1, True, maxiter=200)
    pd["Preconditioner"]["Structured Apply"] = "Auto"
    params = H.Params(pd)
    K = HS.create_matrix(params)
    with TP.no_plan_cache():
        P = H.Preconditioner(K, params,
                             testvector=HS.create_testvector(params, K))
    S = H.Solver(K, P, params)
    x, res = S.apply_inverse(D.structured_rhs(K))
    assert S._dist_structured is not None and S._dist is None
    return int(res.iters)


def _jax_structured_newton(dist):
    from hymls_tpu.solvers.mixed import IterativeRefinementSolver
    params = H.Params(D.mixed_params(dist, None, levels=1,
                                     structured="Auto"))
    K = HS.create_matrix(params)
    with TP.no_plan_cache():
        S = IterativeRefinementSolver(
            K, params, testvector=HS.create_testvector(params, K))
    S.compute()
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    fn, dpl, ex, apl = S.newton_step_fn()
    r = jax.device_get(fn(S.op64.vals, S.solver.op.vals, dpl, ex, apl,
                          jnp.asarray(b, jnp.float64)))
    assert (getattr(S, "_dist_structured", None) is not None) == dist
    return int(r.iters)


def test_dist_structured_gmres(three_ranks):
    """f64 GMRES on Stokes-C 32^2, L = 1, 'Structured Apply' "Auto":
    the sharded structured apply runs (not the halo V-cycle), every
    rank takes the same iterations, the replicated solve's residual is
    reached, and the count is the JAX package's distributed structured
    solve's within its own slack, max(2, 3%)
    (tests/test_dist_solve.py:test_dist_structured_solve)."""
    recs = [o["structured"]["gmres"] for o in three_ranks]
    d, r = recs[0]["dist"], recs[0]["rep"]
    for rec in recs:
        assert rec["sharded"] and not rec["halo"]
        assert rec["dist"]["iters"] == d["iters"]
    assert abs(d["iters"] - r["iters"]) <= max(2, int(r["iters"] * 0.03))
    K = TP.problem(D._solve_params("Stokes-C", 32, 1, True))[0]
    b = D.structured_rhs(K)
    assert TP.relres(K, d["x"], b) <= \
        TP.relres(K, r["x"], b) * (1 + 1e-6) + 1e-12
    jax_iters = _jax_dist(_jax_structured_gmres)
    assert abs(d["iters"] - jax_iters) <= max(2, int(jax_iters * 0.03))


@pytest.mark.parametrize("tag", ["gmres_restart", "cg", "newton_warm",
                                 "ir_solve"])
def test_dist_structured_other_solves(three_ranks, tag):
    """GMRES restarted every 20 on Stokes-C 32^2, L = 1, CG on Laplace
    32^2, L = 2, and the IR solver's newton_step_warm and solve on the
    Newton step's Stokes case, all on the sharded structured apply:
    every rank takes the replicated solve's iterations (on the CPU the
    sharded apply is the replicated one bit for bit) and reaches its
    residual."""
    recs = [o["structured"][tag] for o in three_ranks]
    d, r = recs[0]["dist"], recs[0]["rep"]
    for rec in recs:
        assert rec["sharded"] and not rec["halo"]
        assert rec["dist"]["iters"] == r["iters"]
    if tag in ("newton_warm", "ir_solve"):
        K = TP.problem(D.mixed_params(True, None, levels=1,
                                      structured="Auto"))[0]
        b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
        assert TP.relres(K, d["x"], b) <= 1e-10
        return
    pd = D.structured_solve_params(True, *(("Laplace", 2, "CG")
                                           if tag == "cg" else ()))
    K = TP.problem(pd)[0]
    b = D.structured_rhs(K)
    assert TP.relres(K, d["x"], b) <= \
        TP.relres(K, r["x"], b) * (1 + 1e-6) + 1e-12


def test_dist_structured_newton_step(three_ranks):
    """The IR Newton step on Stokes-C 32^2, L = 1 with the sharded
    structured apply: every rank takes the same inner iterations, within
    2 of the port's replicated step and of the JAX package's distributed
    structured step on 3 virtual devices, to relres 1e-10."""
    recs = [o["structured"]["newton"] for o in three_ranks]
    d, r = recs[0]["dist"], recs[0]["rep"]
    for rec in recs:
        assert rec["sharded"] and not rec["halo"]
        assert rec["dist"]["iters"] == d["iters"]
    assert abs(d["iters"] - r["iters"]) <= 2
    assert abs(d["iters"] - _jax_dist(
        lambda: _jax_structured_newton(True))) <= 2
    K = TP.problem(D.mixed_params(True, None, levels=1,
                                  structured="Auto"))[0]
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    assert TP.relres(K, d["x"], b) <= 1e-10


def test_deflated_and_complex_take_the_halo_with_the_structured_program(
        three):
    """With the structured program active and a mesh, the JAX package's
    deflated and complex solves take no structured branch
    (hymls_tpu/solvers/solver.py:_build_proj_solve,
    complex_solver.py:_build_dist): both build the halo V-cycle.  So
    does the port, on the generic factors, and takes the iterations of
    its replicated (structured) solve.  The JAX package's deflated solve
    then hands its repacked structured factors to the halo stacking and
    raises KeyError 'blkinv' (ROADMAP Queue 3)."""
    for tag in ("deflated", "complex"):
        rec = three["structured_halo"][tag]
        assert rec["active"] and rec["halo"] and not rec["sharded"], tag
        assert rec["dist"]["iters"] == rec["rep"]["iters"], tag
        assert np.abs(rec["dist"]["x"] - rec["rep"]["x"]).max() <= \
            1e-6 * np.abs(rec["rep"]["x"]).max(), tag

    def jax_deflated():
        K = D.aniso_matrix()
        pd = D.precond_params("Laplace", 32, 2, solver={
            "Krylov Method": "GMRES", "Initial Vector": "Zero",
            "Distributed Apply": True, "Deflated Subspace Dimension": 8,
            "Iterative Solver": {"Maximum Iterations": 100,
                                 "Convergence Tolerance": 1e-10}})
        pd["Preconditioner"]["Structured Apply"] = "Auto"
        params = H.Params(pd)
        with TP.no_plan_cache():
            P = H.Preconditioner(K, params, testvector=HS.create_testvector(
                params, K)).compute()
        assert P._structured_active
        S = H.Solver(K, P, params)
        S.setup_deflation()
        with pytest.raises(KeyError, match="blkinv"):
            S.apply_inverse(K @ np.ones(K.shape[0]))
    _jax_dist(jax_deflated)
