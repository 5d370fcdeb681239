"""The port's plan disk cache (hymls_tpu_torch/core/preconditioner.py,
after hymls_tpu/core/preconditioner.py's), with the store threshold at
0 and a fresh cache directory per test: a second construction loads the
cache and builds nothing, its plans and factors are identical to a cold
build's and to the JAX package's, and the key changes with every input
the plan build reads."""
import functools
import os
import pickle
import tempfile

import numpy as np
import pytest

import torch

import hymls_tpu_torch as T
import hymls_tpu_torch.core.preconditioner as TP

from _torch_parity import (problem, pair, assert_plans_identical,
                           assert_factors_agree)


def _cfg(bgrid=True, nx=8):
    """stokes_L2 at 8^3 (tests/test_torch_bgrid.py's setup)."""
    return {
        "Problem": {"Equations": "Stokes-L", "Dimension": 3,
                    "nx": nx, "ny": nx, "nz": nx, "Degrees of Freedom": 4},
        "Driver": {"Galeri Label": "Stokes-L"},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Fix Pressure Level": True,
                           "Apply Dropping": False,
                           "Separator Length (x)": 4,
                           "Separator Length (y)": 4,
                           "Separator Length (z)": nx,
                           "Coarsening Factor": 2,
                           "Number of Levels": 2,
                           "B-Grid Transform": bgrid}}


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("HYMLS_PLAN_CACHE", str(tmp_path))
    monkeypatch.setattr(TP, "PLAN_CACHE_MIN_BUILD_S", 0.0)
    return tmp_path


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]


def test_warm_load_builds_nothing_and_matches(cache_dir, monkeypatch):
    d = _cfg()
    K, tv = problem(d)
    Pj, cold = pair(d, K, tv)
    assert not cold.plan_from_cache
    assert len(list(cache_dir.glob("*.pkl"))) == 1

    def refuse(*a, **k):
        raise AssertionError("a plan was built although it was cached")
    for name in ("build_level_plan", "build_coarse_plan", "build_hierarchy"):
        monkeypatch.setattr(TP, name, refuse)
    warm = T.Preconditioner(K, T.Params(d), testvector=tv,
                            device="cpu").compute()
    assert warm.plan_from_cache
    assert warm.plan_seconds < cold.plan_seconds

    for a, b in zip(cold.factor_plans, warm.factor_plans):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert [p.apply_ot for p in cold.plans] == \
        [p.apply_ot for p in warm.plans]
    assert all(torch.equal(a, b) for a, b in
               zip(_leaves(cold.factors.full), _leaves(warm.factors.full)))
    assert_plans_identical(Pj, warm)
    assert_factors_agree(Pj, warm, scale=float(np.abs(K.data).max()))
    b = K @ np.random.default_rng(3).standard_normal(K.shape[0])
    assert torch.equal(cold.apply_inverse(b), warm.apply_inverse(b))


def test_fast_builds_are_not_stored(tmp_path, monkeypatch):
    """Below the threshold nothing is written; the empty string turns
    the cache off altogether."""
    monkeypatch.setenv("HYMLS_PLAN_CACHE", str(tmp_path))
    monkeypatch.setattr(TP, "PLAN_CACHE_MIN_BUILD_S", 1e9)
    d = _cfg(bgrid=False)
    K, tv = problem(d)
    P = T.Preconditioner(K, T.Params(d), testvector=tv, device="cpu")
    assert not P.plan_from_cache
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("HYMLS_PLAN_CACHE", "")
    assert P._plan_cache_key() is None


def test_default_directory_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("HYMLS_PLAN_CACHE", raising=False)
    d = TP._plan_cache_dir()
    assert d == os.path.join(tempfile.gettempdir(),
                             "hymls_torch_plan_cache")


def test_a_directory_others_may_write_is_refused(tmp_path, monkeypatch):
    """Loading a pickle runs code: a cache directory that group or others
    may write into is neither read nor written, and one of this user's
    own, writable by no one else, is."""
    d = tmp_path / "cache"
    d.mkdir()
    monkeypatch.setenv("HYMLS_PLAN_CACHE", str(d))
    for mode in (0o777, 0o770, 0o702):
        os.chmod(d, mode)
        TP._plan_cache_store("k", {"planted": mode})
        assert list(d.iterdir()) == []
    with open(d / "k.pkl", "wb") as f:
        pickle.dump({"planted": True}, f)
    os.chmod(d, 0o777)
    assert TP._plan_cache_load("k") is None
    os.chmod(d, 0o700)
    assert TP._plan_cache_load("k") == {"planted": True}


def test_a_failed_store_leaves_no_temporary_file(tmp_path, monkeypatch):
    monkeypatch.setenv("HYMLS_PLAN_CACHE", str(tmp_path))

    def full(*a, **k):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(TP.pickle, "dump", full)
    TP._plan_cache_store("k", {"x": 1})
    assert list(tmp_path.iterdir()) == []


def _set(section, key, value):
    def mutate(d):
        d[section][key] = value
    return mutate


# every input the plan build reads, changed one at a time
VARIATIONS = {
    "bgrid": _set("Preconditioner", "B-Grid Transform", True),
    "dropping": _set("Preconditioner", "Apply Dropping", True),
    "variant": _set("Preconditioner", "Preconditioner Variant",
                    "Domain Decomposition"),
    "fix_gid": _set("Preconditioner", "Fix GID 1", 7),
    "levels": _set("Preconditioner", "Number of Levels", 1),
    "testvector": None,
}


@functools.lru_cache(maxsize=None)
def _key(name):
    d = _cfg(bgrid=False)
    if VARIATIONS.get(name) is not None:
        VARIATIONS[name](d)
    K, tv = problem(d)
    if name == "testvector":
        tv = np.ones(K.shape[0])
    return T.Preconditioner(K, T.Params(d), testvector=tv,
                            device="cpu")._plan_cache_key()


@pytest.mark.parametrize("name", list(VARIATIONS))
def test_key_changes_with_each_plan_input(name, cache_dir):
    base = _key("base")
    assert base is not None and _key("base") == base
    assert _key(name) not in (None, base)
