"""The rest of the reference's config suite through the port's driver,
against the JAX driver on the CPU.

Every config of `driver_cases.SUITE_CONFIGS` (the configs of
tests/test_suite_parity.py that build their own matrix and that
tests/test_torch_driver.py does not run) goes through
`run_with_refinements` of both packages at its own size, depth,
factorizations and solves, in f64: the same matrix at every refinement,
the same apply under 'Structured Apply' "Auto", every 'Targets' check
passed, every solve's iterations equal, relres and relerr to 1e-8
relative plus 1e-13 (`assert_same_solves`), the same cost model, and
JDQR as tests/test_torch_driver.py holds it.  The configs the
reference marks slow are marked slow here.

Three configs part by more than 1e-8, and only through rounding
(`SELF_DIFF`, `test_rounding_split`): their plans are identical and
their factors agree to 1e-10, and the reference parts from itself as
far when the right-hand side moves by one ulp.  They are held to twice
that self-difference.  Then the partitioner options that no other port
test reaches, at factor level (`test_option_factors_match_reference`).
"""
import numpy as np
import pytest
import scipy.sparse as sp

import torch

import hymls_tpu.driver as HD
import hymls_tpu.solvers.eigen as HE
from hymls_tpu.config import load_xml as ref_load

import hymls_tpu_torch.driver as TD
import hymls_tpu_torch.solvers.eigen as TE
from hymls_tpu_torch.config import Params, load_xml
from hymls_tpu_torch.stencils import create_nullspace
from hymls_tpu_torch.tools.driver_cases import (SUITE_SLOW, SUITE_TIER1,
                                                constructed, driver_params,
                                                eigen_results)

from _torch_parity import (AGREE, assert_factors_agree,
                           assert_plans_identical, assert_same_solves,
                           no_plan_cache, pair, problem, rel, solver_pair)

# The reference's own one-ulp sensitivity: the largest relative change,
# over a config's solves, of the JAX driver's relres and relerr when
# every solve runs on b moved one ulp up (np.nextafter(b, inf); measured
# by `test_rounding_split` on the CPU).  The port parts from the
# reference by less than twice that, and by more than AGREE:
SELF_DIFF = {
    # relres, relerr.  L = 0: one dense solve of the bordered periodic
    # system (condition 4.7e4); relres 8.2e-13, relerr 4.0e-13 / 6.0e-13
    # (JAX / port: 5.03e-1 apart)
    "stokes4_3D": (2.567e-1, 2.609e-1),
    # 4 solves of 29 iterations to 7e-7 (port: up to 5.87e-8 / 2.46e-7
    # apart)
    "stokes6": (1.305e-7, 6.217e-7),
    # Left-preconditioned GMRES from a Random start, 126 iterations;
    # relres 1.2209e-9 / 1.2105e-9 (port: 8.50e-3 / 6.64e-3 apart)
    "darcy": (2.755e-2, 2.626e-2),
}


def _run(driver, eigen, load, name, **kw):
    """(reports, eigenvalue results, "Auto" took the structured apply
    per refinement) of run_with_refinements on configs/<name>.xml."""
    with eigen_results(eigen) as eigs, constructed(driver) as made:
        reps = driver.run_with_refinements(driver_params(load, name), **kw)
    return reps, eigs, [P._structured_active for P in made["P"]]


def _cached(fn):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = fn(name)
        return cache[name]
    return get


@pytest.fixture(scope="module")
def reference():
    """The JAX driver per config, each run once per module (without the
    reference's shared plan disk cache)."""
    def run(name):
        with no_plan_cache():
            return _run(HD, HE, ref_load, name)
    return _cached(run)


@pytest.fixture(scope="module")
def port():
    return _cached(lambda name: _run(TD, TE, load_xml, name, device="cpu"))


def _assert_matches(name, reference, port):
    rj, ej, sj = reference(name)
    rt, et, st = port(name)
    params = driver_params(load_xml, name)
    for p in TD.refinements(params):
        Kj = HD.get_linear_system(p)[0]
        Kt = TD.get_linear_system(p)[0]
        assert Kj.shape == Kt.shape and (Kj != Kt).nnz == 0
    assert st == sj
    tol = [2 * s for s in SELF_DIFF[name]] if name in SELF_DIFF \
        else [AGREE, AGREE]
    assert len(rt) == len(rj)
    for a, b in zip(rj, rt):
        assert_same_solves(a, b, *tol)
        assert set(b.cost_model) == set(a.cost_model)
        for k in ("compute_gflop", "apply_mflop", "apply_mb"):
            assert b.cost_model[k] == a.cost_model[k], k
    assert len(et) == len(ej)
    how_many = params.sublist("Driver").sublist("Eigenvalues").get(
        "How Many", 10)
    for a, b in zip(ej, et):            # JDQR
        assert b.converged == a.converged == how_many
        assert abs(b.iterations - a.iterations) <= 5
        assert np.abs(np.sort_complex(b.values) -
                      np.sort_complex(a.values)).max() <= 1e-8


@pytest.mark.parametrize("name", SUITE_TIER1)
def test_config_matches_reference(name, reference, port):
    _assert_matches(name, reference, port)


@pytest.mark.slow
@pytest.mark.parametrize("name", SUITE_SLOW)
def test_slow_config_matches_reference(name, reference, port):
    _assert_matches(name, reference, port)


class _OneUlpUp(HD.Solver):
    """The JAX package's Solver, every right-hand side moved one ulp
    up."""

    def apply_inverse(self, b, *a, **k):
        return super().apply_inverse(np.nextafter(np.asarray(b), np.inf),
                                     *a, **k)


def _max_rel(ra, rb, key):
    return max(abs(getattr(sa, key) - getattr(sb, key)) / getattr(sa, key)
               for a, b in zip(ra, rb) for sa, sb in zip(a.solves, b.solves))


def _assert_apply_agrees(name, Pj, Pt, K, ns):
    b = np.random.default_rng(3).standard_normal(K.shape[0])
    if ns is None:
        assert rel(Pj.apply_inverse(b), Pt.apply_inverse(b).numpy()) <= 1e-12
        return
    # The bordered dense solve of the periodic system: each package is
    # held against an LU solve of [K V; V' 0] by numpy.  Each is off by
    # rounding of order cond * eps, 1e-11 (the reference: 1.6e-12 in x
    # and 2.9e-11 in the border coefficients s; the port: 7.8e-12 and
    # 4.5e-12), so the port is held to the larger of the reference's
    # error and cond * eps.
    t = np.zeros(ns.shape[1])
    A = sp.bmat([[K, ns], [ns.T, None]]).toarray()
    z = np.linalg.solve(A, np.concatenate([b, t]))
    n = K.shape[0]
    bound = np.linalg.cond(A) * np.finfo(np.float64).eps
    yj = Pj.apply_inverse_bordered(b, t)
    yt = Pt.apply_inverse_bordered(torch.as_tensor(b), torch.as_tensor(t))
    for part, ref, a, c in (("x", z[:n], yj[0], yt[0]),
                            ("s", z[n:], yj[1], yt[1])):
        ej = rel(ref, np.asarray(a))
        et = rel(ref, np.asarray(c))
        assert et <= max(ej, bound), (name, part, et, ej, bound)


ROUNDING = [pytest.param("stokes4_3D", id="stokes4_3D"),
            pytest.param("stokes6", id="stokes6", marks=pytest.mark.slow),
            pytest.param("darcy", id="darcy", marks=pytest.mark.slow)]


@pytest.mark.parametrize("name", ROUNDING)
def test_rounding_split(name, reference, port, monkeypatch):
    """Why `SELF_DIFF`'s configs part: the same plans, the factors to
    1e-10, one apply to 1e-12 (the bordered direct solve: no less
    accurate than the reference), and the reference's relres and relerr
    moving, under one ulp of b, by at least half as much as the port
    differs from it."""
    d = driver_params(load_xml, name).to_dict()
    K, tv = problem(d)
    ns = None
    if d.get("Driver", {}).get("Null Space Type", "None") != "None":
        ns = create_nullspace(Params(d), K.shape[0])
    Sj, St = solver_pair(d, K, tv, border=ns)
    Pj, Pt = Sj.precond, St.precond
    assert Pt._structured_active == Pj._structured_active
    assert_plans_identical(Pj, Pt)
    assert_factors_agree(Pj, Pt)
    _assert_apply_agrees(name, Pj, Pt, K, ns)

    rj, rt = reference(name)[0], port(name)[0]
    monkeypatch.setattr(HD, "Solver", _OneUlpUp)
    with no_plan_cache():
        rup = HD.run_with_refinements(driver_params(ref_load, name))
    for key in ("relres", "relerr"):
        self_diff = _max_rel(rj, rup, key)
        port_diff = _max_rel(rj, rt, key)
        assert AGREE < port_diff <= 2 * self_diff, (key, port_diff,
                                                    self_diff)


# The partitioner options that no other port test reaches, each at the
# size named: plans identical, per-level factors to 1e-10, one apply to
# 1e-12.  'Eliminate Velocities Together' true, as stokes_THCM sets it,
# is also the partitioners' default (partition/cartesian.py:114); false
# takes their other branch.  'Retain Nodes (z)' 8 keeps whole z-columns
# of stokes_L4 on the next level.
OPTIONS = {"velocities_together": ("stokes_THCM", (8, 8, 8), True),
           "velocities_apart": ("stokes_THCM", (8, 8, 8), False),
           "retain_nodes": ("stokes_L4", (10, 10, 8), None)}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_option_factors_match_reference(case):
    name, (nx, ny, nz), together = OPTIONS[case]
    d = driver_params(load_xml, name).to_dict()
    d["Problem"].update(nx=nx, ny=ny, nz=nz)
    if together is not None:
        d["Preconditioner"]["Eliminate Velocities Together"] = together
    assert d["Preconditioner"]["Number of Levels"] == 2
    K, tv = problem(d)
    Pj, Pt = pair(d, K, tv)
    assert Pt._structured_active == Pj._structured_active
    assert len(Pt.plans) == 2
    assert_plans_identical(Pj, Pt)
    # level 1's assembled Schur values of stokes_THCM are zero up to
    # rounding: measured against the matrix's scale
    assert_factors_agree(Pj, Pt, scale=float(np.abs(K.data).max()))
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    assert rel(Pj.apply_inverse(b), Pt.apply_inverse(b).numpy()) <= 1e-12
