"""The port's spans and counters (hymls_tpu_torch/utils/timings.py
`prof` and `count`) at its layer boundaries, and the benchmark's reading
of them (portbench/spans.py).

A refinement solve on a two-level structured Stokes-C problem under
torch.profiler: every span appears, nested as the layers call each
other, and the counters agree with the solver's own counts.  With no
profiler running and the level above HYMLS_TIMING_LEVEL a scope builds
nothing.  The readers charge device work to the span that launched it
by correlation id, on synthetic traces."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hymls_tpu_torch import Params
from hymls_tpu_torch.solvers import krylov
from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
from hymls_tpu_torch.stencils import create_matrix, create_testvector
from hymls_tpu_torch.utils import timings

from portbench import spans, trace
from portbench.harness import reader
from portbench.tests.helpers import ROOT

STOKES = {"Problem": {"Equations": "Stokes-C", "Dimension": 2,
                      "nx": 16, "ny": 16},
          "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                     "Left or Right Preconditioning": "Right",
                     "Iterative Solver": {"Maximum Iterations": 100,
                                          "Convergence Tolerance": 1e-10}},
          "Preconditioner": {"Partitioner": "Skew Cartesian",
                             "Separator Length": 4, "Number of Levels": 2}}

TABLE = ("hymls.compute", "hymls.compute.L0", "hymls.compute.L1",
         "hymls.compute.coarse", "hymls.compute.repack", "hymls.refine",
         "hymls.refine.residual", "hymls.gmres", "hymls.apply",
         "hymls.apply.L0", "hymls.apply.L1", "hymls.apply.coarse")


def program_spans(prof):
    """{name: [(start, end)]} of the `hymls.` ranges of a profile."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("hymls."):
            out.setdefault(e.name(), []).append(trace._times(e))
    return out


def inside(child, parents):
    return any(s <= child[0] and child[1] <= t for s, t in parents)


@pytest.fixture(scope="module")
def solved():
    """One compute, one refinement solve and one block apply of the
    two-level Stokes-C problem, traced; returns (solver, spans,
    counter deltas, block apply, row-by-row apply)."""
    torch.set_num_threads(1)
    p = Params(STOKES)
    K = create_matrix(p).tocsr()
    S = IterativeRefinementSolver(K, p, testvector=create_testvector(p, K),
                                  device="cpu")
    assert S.precond._structured is not None
    b = K @ np.random.default_rng(1).standard_normal(K.shape[0])
    B = torch.randn(3, K.shape[0], dtype=torch.float32,
                    generator=torch.Generator().manual_seed(2))
    P = S.precond
    before = timings.counter_snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        S.compute(K)
        S.solve(b)
        block = P.apply_fn(P.factors, B)
    delta = spans.diff(timings.counter_snapshot(), before)
    rows = torch.stack([P.apply_fn(P.factors, v) for v in B])
    return S, program_spans(prof), delta, block, rows


def test_every_span_of_a_refinement_solve_appears(solved):
    _, sp, _, _, _ = solved
    assert set(TABLE) <= set(sp), set(TABLE) - set(sp)


def test_spans_nest_as_the_layers_call(solved):
    _, sp, _, _, _ = solved
    chain = ("hymls.apply.coarse", "hymls.apply.L1", "hymls.apply.L0",
             "hymls.apply")
    for child, parent in zip(chain, chain[1:]):
        assert all(inside(c, sp[parent]) for c in sp[child]), child
    # every apply of the solve is inside GMRES, inside the refinement
    # loop; the block apply after it is not
    solve_applies = [a for a in sp["hymls.apply"]
                     if inside(a, sp["hymls.refine"])]
    assert len(solve_applies) == len(sp["hymls.apply"]) - 1
    assert all(inside(a, sp["hymls.gmres"]) for a in solve_applies)
    assert all(inside(g, sp["hymls.refine"]) for g in sp["hymls.gmres"])
    assert all(inside(r, sp["hymls.refine"])
               for r in sp["hymls.refine.residual"])
    for name in TABLE:
        if name.startswith("hymls.compute."):
            assert all(inside(c, sp["hymls.compute"]) for c in sp[name])


def test_counters_agree_with_the_solver(solved):
    S, sp, delta, _, _ = solved
    assert delta["hymls.gmres.iters"] == S.num_iter > 0
    assert delta["hymls.refine.solves"] == 1
    assert delta["hymls.refine.passes"] >= 1
    assert delta["hymls.refine.passes"] == len(sp["hymls.gmres"]) == \
        len(sp["hymls.refine.residual"])
    assert delta["hymls.compute.calls"] == 1
    assert spans.refine_passes(delta) == delta["hymls.refine.passes"]


def test_block_apply_runs_under_the_profiler(solved):
    _, _, _, block, rows = solved
    assert block.shape == rows.shape
    # f32 factors: the batched products round differently from the
    # single ones, within a few hundred f32 ulps of the largest entry
    assert float((block - rows).abs().max()) <= \
        1e-5 * float(rows.abs().max())


def test_cg_span_and_its_iterations():
    A = torch.diag(torch.arange(1.0, 9.0, dtype=torch.float64))
    b = torch.ones(8, dtype=torch.float64)
    before = timings.counter_snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = krylov.cg(lambda v: A @ v, b, torch.zeros_like(b), tol=1e-12,
                        maxiter=20)
        rgm = krylov.gmres(lambda v: A @ v, b, torch.zeros_like(b),
                           tol=1e-10, maxiter=200, restart=4)
    delta = spans.diff(timings.counter_snapshot(), before)
    sp = program_spans(prof)
    assert len(sp["hymls.cg"]) == 1 and len(sp["hymls.gmres"]) == 1
    assert res.converged and rgm.converged and rgm.iters > 4
    assert delta["hymls.gmres.iters"] == res.iters + rgm.iters


def test_off_path_builds_nothing(monkeypatch):
    """No profiler, the level above HYMLS_TIMING_LEVEL, no function
    trace: one shared object, no profiler range, no timer row."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range was built")

    monkeypatch.setattr(timings, "TIMING_LEVEL", 1)
    monkeypatch.setattr(timings, "FUNCTION_TRACING", False)
    monkeypatch.setattr(timings, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    rows = dict(timings._prof_timer()._totals)
    a, b = timings.prof("off-scope", 3), timings.prof("off-scope", 2)
    assert a is b
    with a:
        with timings.prof("off-scope-inner", 3):
            pass
    assert dict(timings._prof_timer()._totals) == rows


def test_profiler_records_every_level_and_times_only_low(monkeypatch):
    monkeypatch.setattr(timings, "TIMING_LEVEL", 1)
    monkeypatch.setattr(timings, "FUNCTION_TRACING", False)
    t = timings._prof_timer()
    n_hi, n_lo = t.count("hymls.test.hi"), t.count("hymls.test.lo")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timings.prof("hymls.test.lo", 1):
            with pytest.raises(ValueError):
                with timings.prof("hymls.test.hi", 3):
                    raise ValueError("propagates")
    sp = program_spans(prof)
    assert len(sp["hymls.test.lo"]) == len(sp["hymls.test.hi"]) == 1
    assert inside(sp["hymls.test.hi"][0], sp["hymls.test.lo"])
    assert t.count("hymls.test.hi") == n_hi
    assert t.count("hymls.test.lo") == n_lo + 1


def test_counters_snapshot_table_and_reset(monkeypatch):
    from collections import defaultdict
    monkeypatch.setattr(timings, "_COUNTERS", defaultdict(int))
    timings.count("hymls.test.a")
    timings.count("hymls.test.a", 4)
    snap = timings.counter_snapshot()
    timings.count("hymls.test.b", 2)
    assert snap == {"hymls.test.a": 5}
    assert spans.diff(timings.counter_snapshot(), snap) == \
        {"hymls.test.a": 0, "hymls.test.b": 2}
    table = timings.print_timing()
    assert "hymls.test.a" in table and "hymls.test.b" in table
    timings.reset_counters()
    assert timings.counter_snapshot() == {}


def test_reset_timing_keeps_the_scopes_in_the_table():
    timings.reset_timing()
    with timings.prof("after-reset", 1):
        pass
    assert "after-reset" in timings.print_timing()


# -- the readers, on a synthetic trace ---------------------------------------

def synthetic():
    """Two applies in a refinement solve, a factorization before it, and
    the device behind the host.  Host (ns): compute [0, 100], refine
    [200, 1000] holding apply [300, 500] (L0 [310, 490] > coarse [400,
    480]) and apply [600, 800] (L0 [610, 790] > coarse [700, 780]).
    Launch j is the runtime call with correlation id j."""
    sp = [(0, 100, "hymls.compute"), (200, 1000, "hymls.refine"),
          (300, 500, "hymls.apply"), (310, 490, "hymls.apply.L0"),
          (400, 480, "hymls.apply.coarse"), (600, 800, "hymls.apply"),
          (610, 790, "hymls.apply.L0"), (700, 780, "hymls.apply.coarse")]
    launches = {1: 10, 2: 320, 3: 410, 4: 620, 5: 710, 6: 900}
    # device intervals run late: kernel 3 runs while the host is already
    # in the second apply's coarse span, kernel 2 during no span at all
    dev = [(50, 150, "factor", 1, 0), (1100, 1200, "level", 2, 0),
           (1200, 1500, "lu", 3, 0), (1500, 1600, "level", 4, 0),
           (1600, 1900, "lu", 5, 0), (1900, 1950, "resid", 6, 0),
           (1950, 2000, "orphan", 99, 0), (2000, 2040, "linked", 98, 7)]
    ops = {7: 420}             # the host op that launched "linked"
    syncs = [(x, "cudaStreamSynchronize in aten::_local_scalar_dense")
             for x in (20, 60, 550, 850, 950)] + [(1050, "cudaMemcpy in ?")]
    return spans.ProgramTrace(sp, launches, ops, syncs, dev, 0, 2100)


def test_device_time_is_charged_by_launch_not_by_overlap():
    pt = synthetic()
    by = spans.device_by_span(pt)
    assert by["hymls.apply.L0"] == pytest.approx(200e-9)
    assert by["hymls.apply.coarse"] == pytest.approx(640e-9)
    assert by["hymls.compute"] == pytest.approx(100e-9)
    assert by["hymls.refine"] == pytest.approx(50e-9)
    assert by[spans.NO_LAUNCH] == pytest.approx(50e-9)   # no launch
    assert spans.OUTSIDE not in by
    # 2 applies: (100 + 300 + 100 + 300 + 40) ns and (300 + 300 + 40) ns
    assert spans.ops_by_span(pt)["hymls.apply.coarse"] == [
        ["lu", pytest.approx(600e-9)], ["linked", pytest.approx(40e-9)]]
    assert spans.apply_device_us(pt) == pytest.approx(1e-3 * 840 / 2)
    assert spans.coarse_device_us(pt) == pytest.approx(1e-3 * 640 / 2)


def test_syncs_are_counted_inside_their_spans():
    pt = synthetic()
    assert spans.syncs_inside(pt, "hymls.refine") == 3
    assert spans.syncs_per_iter(pt, 2) == 1.5
    assert spans.syncs_per_iter(pt, 0) is None
    assert spans.factor_syncs(pt) == 2.0
    item = "cudaStreamSynchronize in aten::_local_scalar_dense"
    assert spans.syncs_by_span(pt) == {"hymls.compute": {item: 2},
                                       "hymls.refine": {item: 3},
                                       spans.OUTSIDE: {"cudaMemcpy in ?": 1}}
    assert spans.is_sync("cudaStreamSynchronize")
    assert spans.is_sync("cudaMemcpy") and not spans.is_sync(
        "cudaMemcpyAsync")
    assert spans.is_runtime("cuLaunchKernel")
    assert spans.is_runtime("cudaLaunchKernel")
    assert not spans.is_runtime("cublasSgemm_v2")
    assert not spans.is_runtime("aten::mm")


def test_no_apply_reads_nothing():
    pt = spans.ProgramTrace([(0, 10, "hymls.refine")], {}, {}, [], [],
                            0, 10)
    assert spans.apply_device_us(pt) is None
    assert spans.coarse_device_us(pt) is None
    assert spans.factor_syncs(pt) is None
    assert spans.refine_passes({}) is None


def test_idle_gaps_take_the_innermost_program_span():
    pt = synthetic()
    # two gaps: (100, 300), midpoint 200, where the host has just opened
    # the refinement loop; (410, 470), midpoint 440, in the first
    # apply's coarse solve.  Without program spans both are the
    # benchmark's "solve".
    dev = [(0, 100, "k"), (300, 410, "k"), (470, 2100, "k")]
    tr = trace.Trace(dev, {"call": [(0, 2100)], "solve": [(150, 2100)]},
                     0, 2100)
    assert spans.idle_by_span(tr, pt) == pytest.approx(
        {"hymls.refine": 200e-9, "hymls.apply.coarse": 60e-9})
    assert trace.idle_by_span(tr) == pytest.approx({"solve": 260e-9})
    outside = spans.ProgramTrace([], {}, {}, [], [], 0, 2100)
    assert spans.idle_by_span(tr, outside) == trace.idle_by_span(tr)


def test_segments_of_nested_spans():
    segs = spans.segments([(0, 100, "a"), (10, 50, "b"), (20, 30, "c"),
                           (60, 70, "d")])
    assert segs == [(0, 10, "a"), (10, 20, "b"), (20, 30, "c"),
                    (30, 50, "b"), (50, 60, "a"), (60, 70, "d"),
                    (70, 100, "a")]


def test_refine_passes_reader_reads_the_program_counters(monkeypatch):
    read = reader(ROOT + "/portbench", "refine_passes.resolve")
    from collections import defaultdict
    monkeypatch.setattr(timings, "_COUNTERS", defaultdict(int))
    assert read(None) is None
    timings.count("hymls.refine.solves", 4)
    timings.count("hymls.refine.passes", 10)
    assert read(None) == 2.5
    # a program without counters reads nothing, and does not raise
    monkeypatch.delattr(timings, "counter_snapshot")
    assert read(None) is None



class Event:
    """A stand-in for one event of a profile's kineto results."""

    def __init__(self, name, start, end, cuda=False, corr=0, linked=0,
                 annotation=False):
        from torch.autograd import DeviceType
        self._n, self._s, self._e = name, start, end
        self._d = DeviceType.CUDA if cuda else DeviceType.CPU
        self._c, self._l, self._a = corr, linked, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def is_user_annotation(self):
        return self._a


def test_program_trace_from_a_profile():
    """Program ranges, launches by correlation id, synchronizing calls
    named by their host op (the profiler's own left out), and device
    events without the device-side annotations of user ranges."""
    from types import SimpleNamespace
    ev = [Event("hymls.apply", 0, 100, corr=1),
          Event("aten::mm", 10, 30, corr=2),
          Event("cudaLaunchKernel", 12, 14, corr=50, linked=2),
          Event("aten::_local_scalar_dense", 40, 60, corr=3),
          Event("cudaStreamSynchronize", 45, 55, corr=51, linked=3),
          Event("Activity Buffer Request", 70, 80, corr=4),
          Event("cudaStreamSynchronize", 71, 72, corr=52, linked=4),
          Event("sgemm", 20, 90, cuda=True, corr=50, linked=2),
          Event("hymls.apply", 0, 95, cuda=True, annotation=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    pt = spans.program_trace(prof, 0, 100)
    assert pt.spans == [(0, 100, "hymls.apply")]
    assert pt.launches == {50: 12, 51: 45, 52: 71}
    assert pt.syncs == [(45, "cudaStreamSynchronize in "
                             "aten::_local_scalar_dense")]
    assert pt.device == [(20, 90, "sgemm", 50, 2)]
    assert spans.device_by_span(pt) == {"hymls.apply": pytest.approx(70e-9)}
