"""'Factor Precision' = 'f64' on an f32 preconditioner (the upcast
factor chain) in the port against the JAX package, on Stokes-C 32^2
L = 2, generic apply (tests/test_dense.py:128-200 and
tests/test_variants.py:237-305).

The values chain (A11inv, G, T11, the Schur values, the next level)
runs in f64, the non-Vsum block inverses and the coarse factor are
inverted in f32, and every factor is stored in f32.  'Schur Assembly'
is 'Full f64' (the default) or 'Vsum f64', which runs the whole chain
in f32 and a small f64 side chain for the next-level values only.

  * plans identical, the split maps included; the factorization's
    transforms are f64, the apply's f32;
  * every stored factor is f32 and lies within 1e-5 of the f64
    reference's, or no further from it than twice the reference's own
    upcast factors;
  * M^{-1} b of the upcast chain is within 1e-4 of the f64 apply and an
    order of magnitude closer than the all-f32 chain's;
  * the split chain's next-level values agree with the full f64
    chain's to 1e-8 relative, its apply factors to 1e-4;
  * through `IterativeRefinementSolver` the inner f32 iteration counts
    are within 2 of the reference's, warm recompute included;
  * the port's V-cycle runs on the reference's own upcast factors.
"""
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import hymls_tpu as H
import hymls_tpu_torch as T
from hymls_tpu.solvers.mixed import IterativeRefinementSolver as JIR
from hymls_tpu_torch.core.preconditioner import (SPLIT_FIELDS,
                                                 _compute_level)
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver as TIR

from _torch_parity import (rel, problem, pair, relres, on_ref_factors,
                           ref_factor_plans, ref_generic,
                           assert_plans_identical, LEVEL_KEYS)

MODES = ["Full f64", "Vsum f64"]


def _cfg(fprec="f64", assembly=None, levels=2, tol=1e-8, **prec):
    prec = {"Separator Length": 4, "Number of Levels": levels,
            "Structured Apply": False, "Factor Precision": fprec, **prec}
    if assembly:
        prec["Schur Assembly"] = assembly
    return {"Problem": {"Equations": "Stokes-C", "Dimension": 2,
                        "nx": 32, "ny": 32},
            "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                       "Iterative Solver": {"Maximum Iterations": 300,
                                            "Convergence Tolerance": tol}},
            "Preconditioner": prec}


@functools.lru_cache(maxsize=None)
def _matrix():
    return problem(_cfg())


@functools.lru_cache(maxsize=None)
def _ref64():
    K, tv = _matrix()
    return H.Preconditioner(K, H.Params(_cfg("Same")), testvector=tv).compute()


@functools.lru_cache(maxsize=None)
def _built(mode):
    K, tv = _matrix()
    return pair(_cfg("f64", mode), K, tv, dtype=torch.float32)


def _close_to_f64(ref64, ref, port, what):
    err = rel(ref64, port)
    bound = max(1e-5, 2.0 * rel(ref64, ref))
    assert err <= bound, f"{what}: {err:.2e} > {bound:.2e}"


@pytest.mark.parametrize("mode", MODES)
def test_upcast_plans_identical(mode):
    Pj, Pt = _built(mode)
    assert Pt._upcast and Pt.factor_dtype == torch.float64
    assert Pt._split_assembly == Pj._split_assembly == (mode == "Vsum f64")
    assert_plans_identical(Pj, Pt)
    for dp, ap in zip(Pt.factor_plans, Pt.generic_plans):
        assert all((k in dp) == (mode == "Vsum f64") for k in SPLIT_FIELDS)
        assert dp["Q"].dtype == dp["w_vals"].dtype == torch.float64
        assert ap["w_vals"].dtype == torch.float32


@pytest.mark.parametrize("mode", MODES)
def test_upcast_factors_match_reference(mode):
    Pj, Pt = _built(mode)
    f64 = _ref64()._factors
    for lev, (a, b, r) in enumerate(zip(Pj._factors["levels"],
                                        Pt.factors.full["levels"],
                                        f64["levels"])):
        for key in LEVEL_KEYS:
            assert b[key].dtype == torch.float32
            _close_to_f64(r[key], a[key], b[key].numpy(), f"{lev} {key}")
    assert Pt.factors.full["coarse"]["inv"].dtype == torch.float32
    _close_to_f64(f64["coarse"]["inv"], Pj._factors["coarse"]["inv"],
                  Pt.factors.full["coarse"]["inv"].numpy(), "coarse")


def test_upcast_apply_beats_the_f32_chain():
    """tests/test_dense.py::test_factor_precision_f64_assembly."""
    K, tv = _matrix()
    r = np.random.default_rng(0).standard_normal(K.shape[0])
    y_ref = np.asarray(_ref64().apply_inverse(r))

    def err(P):
        y = P.apply_inverse(r).numpy().astype(np.float64)
        return np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)

    e_up = err(_built("Full f64")[1])
    e_same = err(T.Preconditioner(K, T.Params(_cfg("Same")), testvector=tv,
                                  dtype=torch.float32,
                                  device="cpu").compute())
    assert e_up < 1e-4, e_up
    assert e_up < e_same / 10, (e_up, e_same)


def test_vsum_split_next_level_values():
    """tests/test_variants.py::
    test_vsum_split_assembly_next_level_accuracy on the port's
    `_compute_level`."""
    K, _ = _matrix()
    vals = torch.as_tensor(K.data, dtype=torch.float64)
    outs = {}
    for mode in MODES:
        Pt = _built(mode)[1]
        outs[mode] = _compute_level(vals, Pt.factor_plans[0],
                                    apply_ot=Pt.plans[0].apply_ot,
                                    store_dtype=torch.float32)
    (ff, nf), (fs, ns_) = outs["Full f64"], outs["Vsum f64"]
    assert nf.dtype == ns_.dtype == torch.float64
    assert rel(nf.numpy(), ns_.numpy()) < 1e-8
    for key in ("G", "A21", "blkinv"):
        assert rel(ff[key].numpy(), fs[key].numpy()) < 1e-4, key
    # and against the reference's split chain
    from hymls_tpu.core.preconditioner import _compute_level as ref_level
    Pj = _built("Vsum f64")[0]
    _, nj = ref_level(jnp.asarray(K.data, jnp.float64),
                      ref_factor_plans(Pj)[0],
                      (Pj.plans[0].n_sep, Pj.plans[0].nnz_sc),
                      apply_ot=Pj.plans[0].apply_ot,
                      store_dtype=jnp.float32)
    assert rel(nj, ns_.numpy()) < 1e-8


def test_vsum_split_levels_option():
    """'Vsum f64 Levels' places the split per level."""
    K, tv = _matrix()
    d = _cfg("f64", "Vsum f64", **{"Vsum f64 Levels": "1"})
    Pj, Pt = pair(d, K, tv, dtype=torch.float32, compute=False)
    assert ["vsum_col" in dp for dp in Pt.factor_plans] == [False, True]
    assert_plans_identical(Pj, Pt)


@pytest.mark.parametrize("mode", MODES)
def test_upcast_apply_on_reference_factors(mode):
    Pj, Pt = _built(mode)
    K, _ = _matrix()
    fac = on_ref_factors(Pt, Pj)
    assert fac.tree["levels"][0]["A11inv"].dtype == torch.float32
    assert fac.plans[0]["w_vals"].dtype == torch.float32
    b = np.random.default_rng(4).standard_normal(K.shape[0])
    b32 = torch.as_tensor(b, dtype=torch.float32)
    yt = Pt.apply_fn(fac, b32)
    assert yt.dtype == torch.float32
    assert rel(Pj.apply_inverse(b), yt.numpy()) <= 1e-4
    # in f64 vectors the f32 factors promote and the apply is exact
    yj = Pj._apply_jit(*ref_generic(Pj), jnp.asarray(b))
    assert rel(yj, Pt.apply_fn(fac, torch.as_tensor(b)).numpy()) <= 1e-12


@pytest.mark.parametrize("mode", MODES)
def test_ir_solver_counts_match_reference(mode):
    """tests/test_variants.py::test_vsum_split_iteration_parity through
    both packages, then a warm recompute of slightly changed values."""
    K, tv = _matrix()
    d = _cfg("f64", mode)
    d["Preconditioner"].pop("Structured Apply")
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    Sj = JIR(K, H.Params(d), testvector=tv).compute()
    St = TIR(K, T.Params(d), testvector=tv, device="cpu").compute()
    assert St.precond.factor_dtype == torch.float64
    assert St.precond.dtype == torch.float32
    assert St.precond._structured_active == Sj.precond._structured_active
    xj = Sj.solve(b)
    xt = St.solve(b)
    assert relres(K, xt.numpy(), b) < 1e-8
    assert abs(St.num_iter - int(Sj._last_result.iters)) <= 2

    K2 = K.copy()
    K2.data = K.data * (1.0 + 1e-6)
    Sj.precond.recompute(K2)
    St.precond.recompute(K2)
    assert St.precond.factors.full["levels"][0]["A11inv"].dtype == \
        torch.float32
    y = np.random.default_rng(5).standard_normal(K.shape[0])
    assert rel(Sj.precond.apply_inverse(y),
               St.precond.apply_inverse(y).numpy()) <= 1e-4


def test_ir_solver_default_is_the_f32_chain():
    K, tv = _matrix()
    d = _cfg("Same")
    S = TIR(K, T.Params(d), testvector=tv, device="cpu")
    assert S.precond.factor_dtype == torch.float32 and not S.precond._upcast


def test_upcast_direct_schur_matches_reference():
    """The upcast chain at L = 0: the dense Schur complement assembled
    in f64, inverted and stored in f32."""
    K, tv = _matrix()
    d = _cfg("f64", levels=0)
    d["Preconditioner"]["Separator Length"] = 8
    Pj, Pt = pair(d, K, tv, dtype=torch.float32)
    d64 = _cfg("Same", levels=0)
    d64["Preconditioner"]["Separator Length"] = 8
    f64 = H.Preconditioner(K, H.Params(d64), testvector=tv).compute()._factors
    for key in ("A11inv", "G", "A21"):
        b = Pt.factors.full["levels"][0][key]
        assert b.dtype == torch.float32
        _close_to_f64(f64["levels"][0][key], Pj._factors["levels"][0][key],
                      b.numpy(), key)
    assert Pt.factors.full["coarse"]["inv"].dtype == torch.float32
    _close_to_f64(f64["coarse"]["inv"], Pj._factors["coarse"]["inv"],
                  Pt.factors.full["coarse"]["inv"].numpy(), "coarse")
