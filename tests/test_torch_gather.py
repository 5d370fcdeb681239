"""The sentinel gather K3 (hymls_tpu_torch/ops/gather.py) on the CPU,
and on the card where there is one.

- The wrapper's plain path is `torch.cat([src, zeros(1)])[idx]` on
  random sources, in f32 and f64, for 1-D, 2-D and 3-D offsets and the
  sentinel, and for a (B, L) source under `torch.func.vmap`, through the
  wrapper and through the block gather's vmap rule.
- On the 2-D, 3-D and THCM configurations of the benchmark (small
  sizes, the generic apply), every gather of a factorization and an
  apply reads offsets in [0, L] of its source, the apply's index fields
  all among them, and equals the plain version; a plan with an offset
  outside [0, L] is refused when it is built.
- The hoisted Householder weights `ot_w` equal the gather they replace,
  bit for bit, in the apply dtype, and `_apply_ot` equals its former
  gather form.
- The counters count the plain path on the CPU; on the card the kernel
  agrees with the plain version, under vmap too, inside a CUDA graph,
  and counts its launches."""
import json
import os

import numpy as np
import pytest
import torch

import hymls_tpu_torch.core.preconditioner as TP
from hymls_tpu_torch import Params
from hymls_tpu_torch.ops import gather as G
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.utils import timings

plain = G.sentinel_gather_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [torch.float32, torch.float64]
IDX_SHAPES = [(7,), (5, 3), (2, 3, 4)]


def _config(name, levels=None, **problem):
    """The benchmark configuration `name` at another size, on the
    generic apply."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           name + ".json")) as f:
        p = json.load(f)["params"]
    p["Problem"].update(problem)
    p["Preconditioner"]["Structured Apply"] = False
    if levels is not None:
        p["Preconditioner"]["Number of Levels"] = levels
    return p


def _f64_factors(p):
    p["Preconditioner"]["Factor Precision"] = "f64"
    return p


#: the benchmark's generic-apply configurations at test sizes (the 2-D
#: one forced onto the generic apply), and the 2-D one with f64 factors
#: under an f32 apply: (parameters, apply dtype)
CASES = {
    "stokes2_2d": (_config("stokes2_128_L3", levels=2, nx=32, ny=32),
                   torch.float64),
    "stokes_3d": (_config("stokes3d_32_L2", nx=8, ny=8, nz=8),
                  torch.float64),
    "thcm": (_config("thcm64x64x8", levels=3, nx=16, ny=16, nz=8),
             torch.float64),
    "stokes2_2d_f64_factors": (
        _f64_factors(_config("stokes2_128_L3", levels=2, nx=32, ny=32)),
        torch.float32),
}


def _random(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _offsets(L, shape, seed):
    """Offsets into [0, L], the sentinel L among them."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, L + 1, size=shape)
    idx.flat[0] = L
    return torch.as_tensor(idx, dtype=torch.int64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", IDX_SHAPES)
def test_plain_path_is_the_appended_zero(dtype, shape):
    src = _random(11, dtype, 1)
    idx = _offsets(11, shape, 2)
    out = G.sentinel_gather(src, idx)
    assert out.dtype == dtype and tuple(out.shape) == shape
    assert torch.equal(out, plain(src, idx))
    assert torch.equal(out.reshape(-1)[0], torch.zeros((), dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", IDX_SHAPES)
@pytest.mark.parametrize("via", ["wrapper", "rule"])
def test_block_under_vmap(dtype, shape, via):
    """A (B, L) source under vmap, batched on either axis: each row is
    the gather of that row."""
    fn = G.sentinel_gather if via == "wrapper" else G._BlockGather.apply
    src = _random((4, 13), dtype, 3)
    idx = _offsets(13, shape, 4)
    rows = torch.stack([plain(s, idx) for s in src])
    for X, dim in ((src, 0), (src.T.contiguous(), 1)):
        out = torch.func.vmap(lambda v: fn(v, idx), in_dims=dim)(X)
        assert tuple(out.shape) == (4, *shape)
        assert torch.equal(out, rows)
    nested = torch.func.vmap(torch.func.vmap(lambda v: fn(v, idx)))(
        src.reshape(2, 2, 13))
    assert torch.equal(nested, rows.reshape(2, 2, *shape))


def test_op_refuses_batched_offsets():
    src = _random((2, 5), torch.float64, 5)
    idx = torch.stack([_offsets(5, (3,), 6), _offsets(5, (3,), 7)])
    with pytest.raises(ValueError, match="batched offsets"):
        torch.func.vmap(G._BlockGather.apply)(src, idx)


def test_empty_source_reads_the_sentinel():
    """A level with no coarse unknowns gathers from an empty vector."""
    idx = torch.zeros(3, dtype=torch.int64)
    for fn in (G.sentinel_gather, G._BlockGather.apply):
        assert torch.equal(fn(torch.zeros(0), idx), torch.zeros(3))


@pytest.fixture(scope="module")
def recorded():
    """Per case: the preconditioner, every `_pgather` of its plan
    build, one factorization and one apply, as (field, src, idx, out),
    and the apply's vector."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the THCM blocks' inverse (PERF.md §7)
    old_cache = os.environ.get("HYMLS_PLAN_CACHE")
    os.environ["HYMLS_PLAN_CACHE"] = ""
    calls = {}
    real = TP._pgather
    try:
        for name, (d, dtype) in CASES.items():
            log = calls[name] = []

            def spy(dp, field, src, log=log):
                out = real(dp, field, src)
                log.append((field, src, dp[field], out))
                return out
            TP._pgather = spy
            p = Params(d)
            K = create_matrix(p)
            P = TP.Preconditioner(K, p, testvector=create_testvector(p, K),
                                  dtype=dtype, device="cpu").compute()
            b = torch.as_tensor(
                np.random.default_rng(8).standard_normal(K.shape[0]),
                dtype=dtype)
            P.apply_fn(P.factors, b)
            TP._pgather = real
            calls[name] = (P, log, b)
    finally:
        TP._pgather = real
        torch.set_num_threads(threads)
        if old_cache is None:
            os.environ.pop("HYMLS_PLAN_CACHE", None)
        else:
            os.environ["HYMLS_PLAN_CACHE"] = old_cache
    return calls


APPLY_INDEX_FIELDS = [f for f in TP.APPLY_FIELDS
                      if f not in TP.LEVEL_FIELDS_FLOAT + ("ot_w",)]


@pytest.mark.parametrize("case", list(CASES))
def test_plan_offsets_lie_in_their_sources(case, recorded):
    P, log, _ = recorded[case]
    seen = set()
    for field, src, idx, out in log:
        L = src.shape[-1]
        assert idx.dtype == torch.int64
        if idx.numel():
            assert int(idx.min()) >= 0 and int(idx.max()) <= L, field
        assert torch.equal(out, plain(src, idx)), field
        seen.add(field)
    # every index field of the apply, where some level has reflectors
    # (`w_pos`, `ot_row_of` are read only then), and the plan's
    # `ot_inv_idx`, which the plan build gathers into `ot_w`
    want = set(APPLY_INDEX_FIELDS) | {"ot_inv_idx"}
    if not any(p.apply_ot for p in P.plans):
        want -= {"w_pos", "ot_row_of"}
    assert want <= seen, sorted(want - seen)
    assert P.max_level >= 2


#: (field, where): an apply offset set below 0 or above L of its
#: source; `blk_inv_idx` above L is the empty block solve's sentinel,
#: which the plan build clamps onto L
OUTSIDE = [(f, w) for f in APPLY_INDEX_FIELDS + ["ot_inv_idx"]
           for w in ("below", "above")
           if (f, w) != ("blk_inv_idx", "above")]


@pytest.mark.parametrize("field,where", OUTSIDE)
def test_plan_build_refuses_offsets_outside_the_source(recorded, field,
                                                        where):
    """An offset that the kernel would read as 0 and the plain version
    would refuse or wrap is refused when the plan is finished."""
    P, _, _ = recorded["stokes_3d"]
    lev = next(lev for lev, p in enumerate(P.plans)
               if np.asarray(getattr(p, field)).size)
    d = TP._device_level(P.plans[lev], P.factor_dtype, "cpu")
    d["ot_inv_idx"] = torch.as_tensor(np.asarray(
        P.plans[lev].ot_inv_idx, dtype=np.int64))
    L = TP._offset_sources(d)[field]
    d[field] = d[field].clone()
    d[field].view(-1)[-1] = -1 if where == "below" else L + 1
    with pytest.raises(ValueError, match=field):
        TP.finish_level_plan(d)


@pytest.mark.parametrize("case", list(CASES))
def test_hoisted_householder_weights(case, recorded):
    P, _, _ = recorded[case]
    for lev, (ap, fp) in enumerate(zip(P.generic_plans, P.factor_plans)):
        inv = torch.as_tensor(np.asarray(P.plans[lev].ot_inv_idx,
                                         dtype=np.int64))
        w = ap["w_vals"]
        assert ap["ot_w"].dtype == w.dtype == P.dtype
        assert torch.equal(ap["ot_w"], plain(w.reshape(-1), inv)), lev
        assert fp["ot_w"].dtype == fp["w_vals"].dtype == P.factor_dtype
        assert "ot_inv_idx" not in fp
        t = _random(inv.shape[0], P.dtype, 9 + lev)
        dots = torch.sum(w * plain(t, ap["w_pos"]), dim=1)
        before = 2.0 * plain(w.reshape(-1), inv) * \
            plain(dots, ap["ot_row_of"]) - t
        assert torch.equal(TP._apply_ot(t, ap), before), lev


def test_counters_count_the_plain_path(recorded):
    P, _, b = recorded["stokes_3d"]
    before = timings.counter_snapshot()
    P.apply_fn(P.factors, b)
    G._BlockGather.apply(b, torch.zeros(2, dtype=torch.int64))
    after = timings.counter_snapshot()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)
    # per level 9 gathers, and 2 in each of its two `_apply_ot`s
    per_level = [9 + 4 * p.apply_ot for p in P.plans]
    assert delta("hymls.gather.plain") == sum(per_level) + 1
    assert delta("hymls.gather.kernel") == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gather kernel has no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", IDX_SHAPES)
def test_kernel_is_the_plain_version(card, dtype, shape):
    src = _random((3, 1001), dtype, 10).to(card)
    idx = _offsets(1001, shape, 11).to(card)
    before = timings.counter_snapshot().get("hymls.gather.kernel", 0)
    one = G.sentinel_gather(src[1], idx)
    block = torch.func.vmap(lambda v: G.sentinel_gather(v, idx))(src)
    strided = torch.func.vmap(lambda v: G.sentinel_gather(v, idx),
                              in_dims=1)(src.T.contiguous())
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        G.sentinel_gather(src[0], idx)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        replayed = G.sentinel_gather(src[0], idx)
    graph.replay()
    torch.cuda.synchronize()
    assert timings.counter_snapshot()["hymls.gather.kernel"] - before == 5
    ref = plain(src.cpu(), idx.cpu())
    assert torch.equal(one.cpu(), ref[1])
    assert torch.equal(block.cpu(), ref)
    assert torch.equal(strided.cpu(), ref)
    assert torch.equal(replayed.cpu(), ref[0])
    with pytest.raises(TypeError):
        G.sentinel_gather(src.to(torch.float16), idx)
