"""The port's structured (gather-free) V-cycle apply against the JAX
package's (hymls_tpu_torch/core/structured.py vs
hymls_tpu/core/structured.py), on a subset of tests/test_structured.py's
configurations.

  * detection: the host detection is a copy of the reference's, so every
    detected level and coarse map, and the "Auto" decision with its
    fallback reason, must be identical;
  * repack: the port's repack of the reference's own generic factors
    (carried over by hymls_tpu_torch.convert) equals the reference's
    repacked factors to 1e-12 relative in f64; one-hot folds round
    nothing, so in f32 the repack equals an explicit gather of the
    generic factors to f32 round-off (TF32 would miss by ~1e-3);
  * apply: the port's structured apply equals the reference's structured
    apply on the same repacked factors, and the port's own generic
    apply, to 1e-12 relative in f64 and 1e-5 in f32 (other summation
    orders, f32 eps ~1.2e-7 times the V-cycle's growth).
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import hymls_tpu as H
from hymls_tpu.solvers.mixed import IterativeRefinementSolver as JIR
import hymls_tpu_torch as T
from hymls_tpu_torch.convert import factors_from_numpy, sfactors_from_numpy
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver as TIR
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian

from _torch_parity import ref_generic, ref_repack

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}

# name -> (equations, problem, preconditioner, dimension); the
# reference's CASES / CASES_3D / SKEW_CASES (tests/test_structured.py)
CASES = {
    "laplace16_L1": ("Laplace", {"nx": 16, "ny": 16},
                     {"Number of Levels": 1}, 2),
    "laplace32_L2": ("Laplace", {"nx": 32, "ny": 32},
                     {"Number of Levels": 2}, 2),
    "laplace48_L2_c3": ("Laplace", {"nx": 48, "ny": 48},
                        {"Number of Levels": 2, "Coarsening Factor": 3}, 2),
    "laplace64x8_s16x4": ("Laplace", {"nx": 64, "ny": 8},
                          {"Number of Levels": 1,
                           "Separator Length (x)": 16,
                           "Separator Length (y)": 4}, 2),
    "stokes16_L1": ("Stokes-C", {"nx": 16, "ny": 16},
                    {"Number of Levels": 1}, 2),
    "darcy32_L2": ("Darcy", {"nx": 32, "ny": 32},
                   {"Number of Levels": 2}, 2),
    "laplace16_xper_L1": ("Laplace", {"nx": 16, "ny": 16,
                                      "x-periodic": True},
                          {"Number of Levels": 1}, 2),
    "laplace32_xyper_L2": ("Laplace", {"nx": 32, "ny": 32,
                                       "x-periodic": True,
                                       "y-periodic": True},
                           {"Number of Levels": 2}, 2),
    "laplace8cube_L1": ("Laplace", {"nx": 8, "ny": 8, "nz": 8},
                        {"Number of Levels": 1}, 3),
    "stokes8cube_L1": ("Stokes-C", {"nx": 8, "ny": 8, "nz": 8},
                       {"Number of Levels": 1}, 3),
    # perm mode (Skew Cartesian)
    "skew_laplace16_L1": ("Laplace", {"nx": 16, "ny": 16},
                          {"Number of Levels": 1,
                           "Partitioner": "Skew Cartesian"}, 2),
    "skew_stokes32_L2": ("Stokes-C", {"nx": 32, "ny": 32},
                         {"Number of Levels": 2,
                          "Partitioner": "Skew Cartesian"}, 2),
    "skew_laplace8cube_L1": ("Laplace", {"nx": 8, "ny": 8, "nz": 8},
                             {"Number of Levels": 1,
                              "Partitioner": "Skew Cartesian"}, 3),
}
F32_CASES = ["laplace32_L2", "stokes16_L1", "skew_laplace16_L1"]


def _params(eq, prob, prec, dim):
    return {"Problem": dict(Equations=eq, Dimension=dim, **prob),
            "Preconditioner": dict({"Separator Length": 4}, **prec)}


def _problem(name):
    d = _params(*CASES[name])
    K = create_matrix(T.Params(d)).tocsr()
    return d, K, create_testvector(T.Params(d), K)


@functools.lru_cache(maxsize=None)
def _pair(name, dtype):
    """(K, reference, port) preconditioners with no 'Structured Apply'
    key ("Auto"), computed; built once per case and dtype and only read
    by the tests."""
    d, K, tv = _problem(name)
    Pj = H.Preconditioner(K, H.Params(d), testvector=tv,
                          dtype=JDT[dtype]).compute()
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv, dtype=dtype,
                          device="cpu").compute()
    return K, Pj, Pt


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert ref.shape == got.shape
    if ref.size == 0:
        return 0.0
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-300))


def _same(a, b, where):
    """Exact equality of detection results (dataclasses, lists, arrays,
    scalars)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", list(CASES))
def test_detection_matches_reference(name):
    _, Pj, Pt = _pair(name, torch.float64)
    assert Pj._structured is not None, Pj._structured_reason
    assert Pt._structured is not None, Pt._structured_reason
    mode = "perm" if "skew" in name else "reshape"
    assert {L.mode for L in Pt._structured.levels} == {mode}
    _same(Pj._structured.levels, Pt._structured.levels, "levels")
    _same(Pj._structured.coarse, Pt._structured.coarse, "coarse")
    assert Pj._structured._offsets == Pt._structured._offsets
    assert Pj._structured._sw == Pt._structured._sw


@pytest.mark.parametrize("name", list(CASES))
def test_repack_matches_reference(name):
    """The port's repack of the reference's generic factors against the
    reference's repacked factors (f64, 1e-12)."""
    _, Pj, Pt = _pair(name, torch.float64)
    generic = factors_from_numpy(_np_tree(ref_generic(Pj)[0]), device="cpu")
    ours = Pt._structured.repack(generic)
    ref = _np_tree(ref_repack(Pj))
    assert len(ours["levels"]) == len(ref["levels"])
    for lev, (a, b) in enumerate(zip(ref["levels"], ours["levels"])):
        for key in ("A11", "A21", "G"):
            assert b[key].dtype == torch.float64
            assert _rel(a[key], b[key]) <= 1e-12, (lev, key)
        assert len(a["blk"]) == len(b["blk"])
        for ci, (x, y) in enumerate(zip(a["blk"], b["blk"])):
            assert _rel(x, y) <= 1e-12, (lev, "blk", ci)


@pytest.mark.parametrize("name", list(CASES))
def test_apply_matches_reference_and_generic(name):
    """f64: the port's structured apply on the reference's repacked
    factors against the reference's structured apply, and on its own
    factors against its own generic apply."""
    K, Pj, Pt = _pair(name, torch.float64)
    b = np.random.default_rng(42).standard_normal(K.shape[0])
    y_ref = np.asarray(Pj.apply_inverse(b))
    sf = sfactors_from_numpy(_np_tree(ref_repack(Pj)), device="cpu")
    y = Pt.apply_fn(dataclasses.replace(Pt.factors, tree=sf),
                    torch.as_tensor(b))
    assert _rel(y_ref, y) <= TOL[torch.float64]
    y_s = Pt.apply_inverse(b)
    y_g = Pt.apply_fn(Pt.factors_of(Pt.factors.full), torch.as_tensor(b))
    assert _rel(y_g, y_s) <= TOL[torch.float64]


@pytest.mark.parametrize("name", list(CASES))
def test_apply_f32_matches_generic(name):
    _, K, tv = _problem(name)
    d = _params(*CASES[name])
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv,
                          dtype=torch.float32, device="cpu").compute()
    assert Pt._structured is not None
    b = np.random.default_rng(7).standard_normal(K.shape[0])
    y_s = Pt.apply_inverse(b)
    assert y_s.dtype == torch.float32
    y_g = Pt.apply_fn(Pt.factors_of(Pt.factors.full),
                      torch.as_tensor(b, dtype=torch.float32))
    assert _rel(y_g, y_s) <= TOL[torch.float32]


@pytest.mark.parametrize("name", F32_CASES)
def test_apply_f32_matches_reference(name):
    """f32: both structured applies on the reference's f32 repacked
    factors."""
    K, Pj, Pt = _pair(name, torch.float32)
    b = np.random.default_rng(8).standard_normal(K.shape[0])
    y_ref = np.asarray(Pj.apply_inverse(b))
    sf = sfactors_from_numpy(_np_tree(ref_repack(Pj)), device="cpu")
    y = Pt.apply_fn(dataclasses.replace(Pt.factors, tree=sf),
                    torch.as_tensor(b, dtype=torch.float32))
    assert y.dtype == torch.float32
    assert _rel(y_ref, y) <= TOL[torch.float32]


def _box_blocks(L, t):
    """Generic per-subdomain blocks (n_sd, r, c) as per-box blocks
    (n_box, r, c): a reshape in roll mode, the box -> subdomain map with
    a zero block for empty boxes in perm mode."""
    if L.mode == "perm":
        t = torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
        return t[torch.as_tensor(L.sd_of_box.reshape(-1))]
    return t.reshape((-1,) + tuple(t.shape[1:]))


def _fold_gather(L, fold_r, fold_c, blocks):
    """Explicit gather of repack's per-class fold: out[box, a, b] =
    blocks[box, m, n] where fold_r[class(box), a, m] and
    fold_c[class(box), b, n] are one, else 0."""
    cls = L.class_of.reshape(-1)
    nbox, r, c = blocks.shape
    rows = np.where(fold_r.any(-1), fold_r.argmax(-1), r)[cls]
    cols = np.where(fold_c.any(-1), fold_c.argmax(-1), c)[cls]
    ext = torch.nn.functional.pad(blocks, (0, 1, 0, 1))
    box = torch.arange(nbox)[:, None, None]
    return ext[box, torch.as_tensor(rows)[:, :, None],
               torch.as_tensor(cols)[:, None, :]]


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device(request.param)


@pytest.mark.parametrize("name", ["cavity16", "skew_stokes32_L2"])
def test_repack_is_exact_in_f32(name, device):
    """The f32 repack equals an explicit gather of the generic factors
    to f32 round-off: the one-hot einsums run in true f32, not TF32
    (the reference pins lax.Precision.HIGHEST for the same reason)."""
    if name == "cavity16":
        d = _cavity16_params()
        K = cavity_jacobian(16, 16, re=1000.0).tocsr()
    else:
        d, K, _ = _problem(name)
    tv = create_testvector(T.Params(d), K)
    P = T.Preconditioner(K, T.Params(d), testvector=tv, dtype=torch.float32,
                         device=device).compute()
    prog = P._structured
    assert prog is not None
    for lev, L in enumerate(prog.levels):
        f = P.factors.full["levels"][lev]
        s = P.factors.tree["levels"][lev]
        checks = [("A11", L.sel, L.sel, f["A11inv"]),
                  ("A21", L.pc, L.sel, f["A21"]),
                  ("G", L.sel, L.pc, f["G"])]
        for key, fr, fc, gen in checks:
            want = _fold_gather(L, fr, fc, _box_blocks(L, gen.cpu()))
            got = s[key].cpu().reshape(want.shape)
            scale = float(gen.abs().max())
            assert float((got - want).abs().max()) <= 1e-6 * scale, key
        blk = torch.cat([f["blkinv"].cpu(),
                         f["blkinv"].new_zeros((1,) + tuple(
                             f["blkinv"].shape[1:])).cpu()])
        for ci, C in enumerate(L.combos):
            bm = np.where(C.blk_map >= 0, C.blk_map,
                          f["blkinv"].shape[0]).reshape(-1)
            want = _fold_gather(L, L.emb[ci], L.emb[ci],
                                blk[torch.as_tensor(bm)])
            got = s["blk"][ci].cpu().reshape(want.shape)
            scale = max(float(f["blkinv"].abs().max()), 1e-30)
            assert float((got - want).abs().max()) <= 1e-6 * scale, ci


def _cavity16_params():
    """bench.py's cavity parameters at 16^2, with no 'Structured Apply'
    key."""
    return {"Problem": {"Equations": "Stokes-C", "Dimension": 2, "nx": 16,
                        "ny": 16},
            "Solver": {"Krylov Method": "GMRES",
                       "Left or Right Preconditioning": "Right",
                       "Initial Vector": "Zero",
                       "Iterative Solver": {"Maximum Iterations": 250,
                                            "Convergence Tolerance": 1e-12}},
            "Preconditioner": {"Partitioner": "Cartesian",
                               "Separator Length": 4,
                               "Number of Levels": 1}}


@pytest.mark.parametrize("case", ["cavity16", "laplace32"])
def test_default_is_structured(case):
    """With no 'Structured Apply' key both packages take the structured
    apply (the port used to run the generic one)."""
    if case == "cavity16":
        d = _cavity16_params()
        K = cavity_jacobian(16, 16, re=1000.0).tocsr()
    else:
        d = _params("Laplace", {"nx": 32, "ny": 32},
                    {"Number of Levels": 1}, 2)
        K = create_matrix(T.Params(d)).tocsr()
    assert "Structured Apply" not in d["Preconditioner"]
    tv = create_testvector(T.Params(d), K)
    Pj = H.Preconditioner(K, H.Params(d), testvector=tv)
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv, device="cpu")
    assert Pj._structured is not None
    assert Pt._structured is not None and Pt._structured_active
    assert Pt.factors.plans is Pt._structured.consts


@pytest.mark.parametrize("setting,reason", [
    ("Auto", "periodic skew not structured"),
    (False, "disabled by parameter"),
])
def test_fallback_matches_reference(setting, reason):
    """Where the reference keeps the generic apply, so does the port,
    with the same reason; the generic path still solves."""
    d = _params("Laplace", {"nx": 16, "ny": 16, "x-periodic": True},
                {"Number of Levels": 1, "Partitioner": "Skew Cartesian",
                 "Structured Apply": setting}, 2)
    K = create_matrix(T.Params(d)).tocsr()
    tv = create_testvector(T.Params(d), K)
    Pj = H.Preconditioner(K, H.Params(d), testvector=tv)
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv, device="cpu")
    assert Pj._structured is None and Pt._structured is None
    assert Pt._structured_reason == Pj._structured_reason == reason
    x = Pt.compute().apply_inverse(
        np.random.default_rng(0).standard_normal(K.shape[0]))
    assert bool(torch.isfinite(x).all())


def test_structured_true_raises_when_detection_fails():
    d = _params("Laplace", {"nx": 16, "ny": 16, "x-periodic": True},
                {"Number of Levels": 1, "Partitioner": "Skew Cartesian",
                 "Structured Apply": True}, 2)
    K = create_matrix(T.Params(d)).tocsr()
    with pytest.raises(ValueError, match="periodic skew"):
        T.Preconditioner(K, T.Params(d), device="cpu")


def test_lower_triangular_structured_matches_reference():
    """tests/test_structured.py's Lower Triangular Stokes case: the
    variant lives in the plans, and both packages run it on the
    structured apply with the same result."""
    d = _params("Stokes-C", {"nx": 32, "ny": 32},
                {"Number of Levels": 2,
                 "Preconditioner Variant": "Lower Triangular"}, 2)
    K = create_matrix(T.Params(d)).tocsr()
    tv = create_testvector(T.Params(d), K)
    Pj = H.Preconditioner(K, H.Params(d), testvector=tv).compute()
    Pt = T.Preconditioner(K, T.Params(d), testvector=tv,
                          device="cpu").compute()
    assert Pj._structured_active and Pt._structured_active
    b = np.random.default_rng(0).standard_normal(K.shape[0])
    yj = np.asarray(Pj.apply_inverse(b))
    yt = Pt.apply_inverse(b).numpy()
    assert np.abs(yj - yt).max() <= 1e-10 * np.abs(yj).max()


@pytest.mark.parametrize("name", ["laplace32_L2", "laplace64x8_s16x4",
                                  "stokes8cube_L1", "skew_stokes32_L2"])
@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_sharded_split_follows_reference(name, ranks):
    """Which levels the sharded apply splits, and how (no ranks needed:
    the split is planned when the apply is made): as the reference's
    sharded_apply_fn, a level not in "perm" mode whose largest box axis
    (the first of equal ones) holds at least one box per rank, along
    that axis; here in contiguous slabs that differ by at most one
    plane, so no rank is left empty."""
    import types
    from hymls_tpu_torch.core.structured import ShardedApply
    _, Pj, Pt = _pair(name, torch.float64)
    mesh = types.SimpleNamespace(size=ranks, rank=0)
    slabs = ShardedApply(Pt._structured, mesh).slabs
    assert len(slabs) == len(Pj._structured.levels)
    for L, sl in zip(Pj._structured.levels, slabs):
        dims = [L.nK, L.nJ, L.nI]
        if L.mode == "perm" or max(dims) < ranks:
            assert sl is None
            continue
        assert sl.ax == dims.index(max(dims))
        assert sum(sl.sizes) == dims[sl.ax] and len(sl.sizes) == ranks
        assert max(sl.sizes) - min(sl.sizes) <= 1 and min(sl.sizes) >= 1
        assert list(sl.sizes) == sorted(sl.sizes, reverse=True)


def test_cavity16_newton_step_counts_match_reference():
    """The IR Newton step and a plain f64 GMRES solve on cavity 16^2 at
    Re 1000, both packages on the structured apply: the same inner f32
    and f64 iteration counts."""
    d = _cavity16_params()
    K = cavity_jacobian(16, 16, re=1000.0).tocsr()
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    tv = create_testvector(T.Params(d), K)

    Sj = JIR(K, H.Params(d), testvector=tv).compute()
    assert Sj.precond._structured is not None
    fn, dplans, extra, aplans = Sj.newton_step_fn()
    rj = fn(Sj.op64.vals, Sj.solver.op.vals, dplans, extra, aplans,
            jnp.asarray(b))
    _, rj64 = H.Solver(K, Sj.precond, H.Params(d),
                       dtype=jnp.float64).apply_inverse(b)

    St = TIR(K, T.Params(d), testvector=tv, device="cpu").compute()
    assert St.precond._structured_active
    rt = St.newton_step(St.op64.vals, St.solver.op.vals, b)
    x, rt64 = T.Solver(K, St.precond, T.Params(d),
                       device="cpu").apply_inverse(b)
    assert rt.converged and rt64.converged
    assert rt.iters == int(rj.iters)
    assert rt64.iters == int(rj64.iters)
    for sol in (rt.x, x):
        sol = sol.numpy()
        assert np.linalg.norm(K @ sol - b) / np.linalg.norm(b) <= 1e-11
