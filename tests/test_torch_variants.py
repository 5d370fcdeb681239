"""The 'Preconditioner Variant's in the port against the JAX package.

The four variants beside 'Block Diagonal' live in the plans: 'Lower
Triangular' and 'Upper Triangular' use the linked-set blocks (on the
dropped pattern their sweeps equal the block-diagonal apply), 'Domain
Decomposition' one block over all non-Vsum nodes, 'Do Nothing' no block
at all.  On the setups of tests/test_variants.py:121-192 (skew Stokes-C
16^2 and Laplace 32^2, L = 1): plans identical, factors to 1e-10
relative, M^{-1} b to 1e-10, f64 GMRES counts equal, and the relations
between the variants that the reference's tests assert.

'Do Nothing' has no structured apply in the port: the reference's
detection stumbles over plans without blocks on Cartesian levels, so
the port falls back to the generic apply there and is held against the
reference's generic apply.
"""
import functools

import numpy as np
import pytest

import hymls_tpu_torch as T

from _torch_parity import (rel, problem, pair, relres,
                           assert_plans_identical, assert_factors_agree,
                           solve_both)

VARIANTS = ["Lower Triangular", "Upper Triangular", "Domain Decomposition",
            "Do Nothing"]
GRIDS = ["skew_stokes16", "laplace32"]


def _cfg(grid, variant, maxiter=150, **prec):
    if grid == "skew_stokes16":
        prob = {"Equations": "Stokes-C", "Dimension": 2, "nx": 16, "ny": 16}
        prec = {"Partitioner": "Skew Cartesian", **prec}
    else:
        prob = {"Equations": "Laplace", "Dimension": 2, "nx": 32, "ny": 32}
    return {"Problem": prob,
            "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                       "Left or Right Preconditioning": "Right",
                       "Iterative Solver": {"Maximum Iterations": maxiter,
                                            "Convergence Tolerance": 1e-10}},
            "Preconditioner": {"Separator Length": 4, "Number of Levels": 1,
                               "Preconditioner Variant": variant, **prec}}


@functools.lru_cache(maxsize=None)
def _built(grid, variant):
    d = _cfg(grid, variant)
    d_ref = None
    if variant == "Do Nothing":
        d_ref = _cfg(grid, variant, **{"Structured Apply": False})
    K, tv = problem(d)
    Pj, Pt = pair(d, K, tv, d_ref=d_ref)
    return d, d_ref, K, Pj, Pt


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("grid", GRIDS)
def test_variant_plans_and_factors_match_reference(grid, variant):
    _, _, _, Pj, Pt = _built(grid, variant)
    assert_plans_identical(Pj, Pt)
    assert_factors_agree(Pj, Pt)
    n_blk = Pt.factors.full["levels"][0]["blkinv"].shape[0]
    if variant == "Do Nothing":
        assert n_blk == 0
    elif variant == "Domain Decomposition":
        assert n_blk == 1
    else:
        assert n_blk > 1


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("grid", GRIDS)
def test_variant_apply_and_counts_match_reference(grid, variant):
    d, d_ref, K, Pj, Pt = _built(grid, variant)
    structured = variant in ("Lower Triangular", "Upper Triangular")
    assert Pt._structured_active == structured
    assert Pj._structured_active == structured
    if not structured:
        assert Pt._structured_reason == f"{variant} variant"
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    assert rel(Pj.apply_inverse(b), Pt.apply_inverse(b).numpy()) <= 1e-10
    (_, rj), (xt, rt) = solve_both(d, K, Pj, Pt, b, d_ref=d_ref)
    assert rt.iters == int(rj.iters)
    assert rt.converged == bool(rj.converged)
    # 'Do Nothing' leaves the non-Vsum part unpreconditioned: GMRES
    # stagnates or, on singular Stokes, drifts along the pressure mode,
    # in both packages alike
    if variant != "Do Nothing":
        assert rt.converged and relres(K, xt, b) <= 1e-9


@pytest.mark.parametrize("grid", GRIDS)
def test_triangular_variants_equal_block_diagonal(grid):
    """tests/test_variants.py::test_preconditioner_variants_equivalent."""
    d = _cfg(grid, "Block Diagonal")
    K, tv = problem(d)
    b = np.random.default_rng(3).standard_normal(K.shape[0])
    ref = T.Preconditioner(K, T.Params(d), testvector=tv,
                           device="cpu").apply_inverse(b).numpy()
    for variant in ("Lower Triangular", "Upper Triangular"):
        y = _built(grid, variant)[4].apply_inverse(b).numpy()
        assert np.allclose(y, ref, rtol=0, atol=1e-12), variant


def test_domain_decomposition_is_the_stronger_variant():
    """tests/test_variants.py::test_domain_decomposition_variant."""
    d = _cfg("laplace32", "Block Diagonal", maxiter=100)
    K, tv = problem(d)
    b = K @ np.random.default_rng(7).standard_normal(K.shape[0])
    P_bd = T.Preconditioner(K, T.Params(d), testvector=tv, device="cpu")
    P_dd = _built("laplace32", "Domain Decomposition")[4]
    assert not np.allclose(P_dd.apply_inverse(b).numpy(),
                           P_bd.apply_inverse(b).numpy(), rtol=0, atol=1e-12)
    iters = {}
    for name, P in (("bd", P_bd), ("dd", P_dd)):
        _, res = T.Solver(K, P, T.Params(d), device="cpu").apply_inverse(b)
        assert res.converged
        iters[name] = res.iters
    assert iters["bd"] <= 21 and iters["dd"] <= iters["bd"]


def test_an_unknown_variant_is_block_diagonal():
    """As in the reference, `build_level_plan` takes any other name
    for the linked-set blocks."""
    d = _cfg("laplace32", "No Such Variant")
    K, tv = problem(d)
    Pj, Pt = pair(d, K, tv)
    assert_plans_identical(Pj, Pt)
    b = np.random.default_rng(3).standard_normal(K.shape[0])
    bd = T.Preconditioner(K, T.Params(_cfg("laplace32", "Block Diagonal")),
                          testvector=tv, device="cpu")
    assert rel(bd.apply_inverse(b).numpy(), Pt.apply_inverse(b).numpy()) == 0
