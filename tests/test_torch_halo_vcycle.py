"""The port's neighbour-halo V-cycle (hymls_tpu_torch.parallel.
halo_vcycle) on 3 and 4 gloo ranks: bit-identical to the port's
replicated generic apply on the CPU (3 ranks: ceil-block padding and a
deactivated rank on the coarse level of the L = 2 cases), within 1e-12
of the JAX package's halo apply, with only ppermute on the level path,
one all_gather of the coarse right-hand side per apply, and per level
the words of the JAX plan's send lists (in place of the reference's
compiled-program greps, tests/test_halo_vcycle.py:74-112)."""
import numpy as np
import pytest

import _torch_parity as TP
import _torch_dist as D

import jax.numpy as jnp

from hymls_tpu.parallel import halo_vcycle as jhv
from hymls_tpu.parallel.mesh import make_mesh

from hymls_tpu_torch.parallel import launch

CASES = [("Laplace", 32, 1), ("Laplace", 32, 2), ("Stokes-C", 32, 2),
         ("Laplace", 16, 1, "Cartesian", 3),
         ("Laplace", 32, 2, "Skew Cartesian")]
# the cases also held against the JAX package's halo apply
JAX_CASES = (2,)


@pytest.fixture(scope="module", params=[3, 4])
def ranks(request):
    ndev = request.param
    return ndev, launch.run(D.halo_vcycle, ndev, backend="gloo",
                            device="cpu", args=(CASES,), timeout_s=300)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_halo_vcycle_bit_identical(ranks, case):
    ndev, out = ranks
    for rec in (o[case] for o in out):
        assert rec["equal"], \
            f"max diff {np.abs(rec['x'] - rec['x_rep']).max()}"


def test_deactivated_rank_on_the_coarse_level(ranks):
    """Laplace 32^2, L = 2: 4 coarse subdomains in blocks of 2 on 3
    ranks leave rank 2 with sentinel work only."""
    ndev, out = ranks
    assert out[0][1]["B"] == [-(-64 // ndev), -(-4 // ndev)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_halo_traffic(ranks, case):
    ndev, out = ranks
    d = D.precond_params(*CASES[case])
    K, tv = TP.problem(d)
    Pj, _ = TP.pair(d, K, tv, compute=False)
    levels, _, meta, _ = jhv.build_halo_plans(Pj, ndev)
    for r, o in enumerate(out):
        c = o[case]["counters"]
        # the level path is ppermute only: one all_gather (the coarse
        # right-hand side) per apply, no psum
        assert c["all_gather"]["calls"] == 1
        assert c["psum"]["calls"] == 0
        want = {}
        for lev, (lm, dp) in enumerate(zip(meta, levels)):
            for pre in ("y2", "nx", "up", "x2"):
                for off in lm.get(f"{pre}_offsets", []):
                    w = dp[f"{pre}_send_{off}"].shape[1]
                    key = f"L{lev}:{pre}"
                    want[key] = want.get(key, 0) + \
                        (w if 0 <= r + off < ndev else 0)
        assert c["ppermute_words"] == want
        assert c["ppermute"]["calls"] == sum(
            len(lm.get(f"{p}_offsets", [])) for lm in meta
            for p in ("y2", "nx", "up", "x2"))
        assert c["ppermute"]["bytes"] == 8 * sum(want.values())
        # per level, O(boundary) words, far below the owned nodes
        for lev, lm in enumerate(meta):
            sent = sum(v for k, v in want.items()
                       if k.startswith(f"L{lev}:"))
            assert sent < lm["max_onod"]


@pytest.mark.parametrize("case", JAX_CASES)
def test_halo_vcycle_matches_jax_halo(ranks, case):
    ndev, out = ranks
    d = D.precond_params(*CASES[case])
    K, tv = TP.problem(d)
    Pj, _ = TP.pair(d, K, tv)
    app = jhv.make_halo_apply(Pj, make_mesh(ndev)).place()
    b = np.random.default_rng(0).standard_normal(K.shape[0])
    x_j = np.asarray(app(jnp.asarray(b)))
    assert TP.rel(x_j, out[0][case]["x"]) < 1e-12


def test_halo_vcycle_bordered(ranks):
    """The bordered halo apply (one psum of the m-vector border tail per
    level) against the port's replicated bordered apply and the JAX
    package's bordered halo apply, to 1e-12 (the psum sums the ranks'
    partial border products in another order than the replicated
    product, so this one is not bit-identical)."""
    from hymls_tpu import Preconditioner as JP, Params as JPar
    from hymls_tpu.stencils import create_nullspace, laplace2d_neumann, \
        create_testvector
    ndev, out = ranks
    rec = out[0][-1]
    assert all(o[-1]["psum"] == 2 for o in out)       # one per level
    scale = np.abs(rec["x_rep"]).max()
    assert np.abs(rec["x"] - rec["x_rep"]).max() / scale < 1e-12
    assert np.abs(rec["s"] - rec["s_rep"]).max() < \
        1e-12 * max(np.abs(rec["s_rep"]).max(), 1)

    params = JPar({
        "Problem": {"Equations": "Laplace", "Dimension": 2, "nx": 32,
                    "ny": 32},
        "Driver": {"Null Space Type": "Constant"},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 2,
                           "Structured Apply": False}})
    K = laplace2d_neumann(32, 32)
    with TP.no_plan_cache():
        P = JP(K, params, testvector=create_testvector(params, K))
    P.set_border(jnp.asarray(create_nullspace(params, K.shape[0])))
    P.compute()
    app = jhv.make_halo_apply(P, make_mesh(ndev)).place()
    rng = np.random.default_rng(4)
    b = rng.standard_normal(K.shape[0])
    t = rng.standard_normal(1)
    x_j, s_j = app.apply_bordered(jnp.asarray(b), jnp.asarray(t))
    assert TP.rel(np.asarray(x_j), rec["x"]) < 1e-12
    assert np.abs(np.asarray(s_j) - rec["s"]).max() < \
        1e-12 * max(np.abs(rec["s"]).max(), 1)
