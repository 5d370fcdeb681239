"""The port's mesh, collectives and launcher (hymls_tpu_torch.parallel.
mesh, collectives, launch), and its host plan builders against the JAX
package's: `build_halo_plans`, `build_factor_plans` and
`build_matvec_plan` return equal arrays for the same matrix, parameters
and number of ranks.  The collectives run on gloo ranks spawned by
`launch.run` (tests/_torch_dist.py holds the rank bodies)."""
import time

import numpy as np
import pytest

import _torch_parity as TP  # noqa: F401  (one thread; native planners)
import _torch_dist as D

from hymls_tpu.parallel import dist as jdist
from hymls_tpu.parallel import dist_compute as jdc
from hymls_tpu.parallel import halo_vcycle as jhv

from hymls_tpu_torch.parallel import dist as tdist
from hymls_tpu_torch.parallel import dist_compute as tdc
from hymls_tpu_torch.parallel import halo_vcycle as thv
from hymls_tpu_torch.parallel import launch


def assert_same(a, b, where="plans"):
    """Equal nested dicts/lists of arrays and python values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


PLAN_CASES = [("Laplace", 32, 1), ("Laplace", 32, 2), ("Stokes-C", 32, 2),
              ("Laplace", 16, 1, "Cartesian", 3),
              ("Stokes-C", 32, 2, "Skew Cartesian", 2, 3)]


@pytest.fixture(scope="module", params=PLAN_CASES,
                ids=lambda c: "-".join(map(str, c)))
def both(request):
    d = D.precond_params(*request.param)
    K, tv = TP.problem(d)
    Pj, Pt = TP.pair(d, K, tv, compute=False)
    return K, Pj, Pt


@pytest.mark.parametrize("ndev", [2, 3, 4])
def test_plans_equal_reference(both, ndev):
    K, Pj, Pt = both
    ref = jhv.build_halo_plans(Pj, ndev)
    got = thv.build_halo_plans(Pt, ndev)
    assert_same(ref, got, "build_halo_plans")
    assert_same(jdc.build_factor_plans(Pj, ndev),
                tdc.build_factor_plans(Pt, ndev), "build_factor_plans")
    bm = got[3]
    args = (np.asarray(bm["gather_idx"]), bm["max_onod0"], ndev)
    assert_same(jdist.build_matvec_plan(K.copy(), *args),
                tdist.build_matvec_plan(K.copy(), *args),
                "build_matvec_plan")


@pytest.fixture(scope="module")
def primitives():
    """One 3-rank spawn: the primitives, then the slab rolls on the 3
    ranks and on a mesh of ranks 0 and 1."""
    return launch.run(D.primitives, 3, backend="gloo", device="cpu",
                      timeout_s=120)


def test_collectives_on_three_ranks(primitives):
    """ppermute on a ring and without wrap-around (the ends receive
    zeros), psum of real and complex tensors, tiled all_gather with
    zero-size shards, and the counters each call leaves."""
    out = primitives
    xs = [o["x"] for o in out]
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["ring"], xs[(r - 1) % 3])
        want = xs[r + 1] if r + 1 < 3 else np.zeros(4)
        np.testing.assert_array_equal(o["shift"], want)
        np.testing.assert_array_equal(o["psum"], sum(xs))
        np.testing.assert_array_equal(o["psum_c"], sum(xs) - 2j * sum(xs))
        # shards of 0, 2 and 1 rows
        np.testing.assert_array_equal(
            o["gather"], np.array([[1.0, 1.0], [1.0, 1.0], [2.0, 2.0]]))
        np.testing.assert_array_equal(o["gather_equal"],
                                      np.concatenate([x[:2] for x in xs]))
        c = o["counters"]
        assert c["ppermute"]["calls"] == 2
        # 4 doubles to the ring successor; rank 0 sends nothing leftward
        assert c["ppermute"]["bytes"] == 32 * (1 + (r > 0))
        assert c["ppermute_words"] == {"ring": 4, "shift": 4 * (r > 0)}
        assert c["psum"] == {"calls": 2, "bytes": 32 + 64}
        # the padded shard of the uneven gather, then the equal one
        assert c["all_gather"] == {"calls": 2, "bytes": 32 + 16}


@pytest.mark.parametrize("ranks", [2, 3])
def test_slab_roll_equals_torch_roll(primitives, ranks):
    """The sharded structured apply's roll (core/structured.py
    roll_slab): every rank's rolled slab, gathered, is torch.roll of the
    whole box grid bit for bit, the wrap from the last rank to the first
    included, for shifts of both signs along each box axis, split
    unevenly (7 planes: 4/3 on 2 ranks, 3/2/2 on 3) or evenly, down to
    slabs of one plane; a shift wider than the smallest slab raises on
    every rank."""
    import torch
    g = torch.as_tensor(D.roll_grid())
    key = "rolls" if ranks == 3 else "rolls2"
    outs = [o[key] for o in primitives[:ranks]]
    for o in outs:
        assert len(o) == 1 + 2 + 4 + 4        # K: ±1; J, I: ±1, ±2
        for ax in (0, 1, 2):
            for s in D.ROLL_SHIFTS:
                if (ax, s) in o:
                    np.testing.assert_array_equal(
                        o[(ax, s)], torch.roll(g, s, dims=ax).numpy())
        assert o["wide"] is not None and "crosses a slab" in o["wide"]


def test_launch_raises_a_childs_exception():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch.run(D.fail_on, 2, backend="gloo", device="cpu", args=(1,),
                   timeout_s=120)


def test_launch_deadline_ends_a_hang():
    """A collective that never completes fails the run at its deadline
    (the process group's timeout or the parent's kill), not the test
    suite's clock."""
    t0 = time.monotonic()
    with pytest.raises(Exception):
        launch.run(D.hang, 2, backend="gloo", device="cpu", timeout_s=8)
    assert time.monotonic() - t0 < 60
