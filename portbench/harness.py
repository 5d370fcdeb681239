"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

Everything a cell is made of is found by name from BENCHMARK.json: the
configuration's file (`configs/<name>.json`, its matrix generator in
`matrices/`), the traffic mix (`mixes/<traffic>.json`, data that
`inputs.py` reads) and one reader per per-layer metric
(`metrics/<name>.py`, else `metrics/<name up to its first dot>.py`).  The
program under test is hymls_tpu_torch's Newton-loop entry,
`solvers.mixed.IterativeRefinementSolver`: each call of a mix factors
(`compute(K)` or the warm recompute, where the mix has a factorization in
every call) and solves (`solve(b)`, as many as the mix says).
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np

from . import inputs, kernels, stats, trace as tracemod
from .hostload import HostLoad
from .reference import solve as ref

#: top-level module names that may not be loaded by a run
BANNED = ("jax", "jaxlib", "flax", "hymls_tpu")


def banned_modules() -> list:
    """The loaded modules whose whole top-level name is banned."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def load_cell(root: str, workload: str) -> SimpleNamespace:
    """The cell `workload` of root/BENCHMARK.json with its configuration,
    mix and metric entries."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    bench_dir = os.path.join(root, bench["paths"][0])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(bench_dir, "mixes", cell["traffic"] + ".json")) as f:
        mix = json.load(f)

    def mine(m):
        return workload in m.get("workloads", [workload])

    return SimpleNamespace(
        name=workload, cell=cell, cfg=cfg, mix=mix, bench_dir=bench_dir,
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)])


def reader(bench_dir: str, name: str) -> Callable:
    """The `read(rec)` of the metric `name`."""
    d = os.path.join(bench_dir, "metrics")
    path = os.path.join(d, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(d, name.split(".")[0] + ".py")
    return inputs.load_module(path, "portbench_metric_" +
                              name.replace(".", "_")).read


def end_to_end(name: str, call: str, window_s: float, durations) -> float:
    """`<call>_s` is the window over the calls; `<call>_p<q>_s` the q-th
    percentile of every call's time; `setup_s` is not read here."""
    if name == f"{call}_s":
        return stats.rate_s(window_s, len(durations))
    head, _, q = name[:-2].rpartition("_p")
    if head == call and name.endswith("_s") and q.isdigit():
        return stats.percentile(durations, float(q))
    raise KeyError(f"end-to-end metric {name!r} is not one of a "
                   f"{call!r} mix")


class Spans:
    """The benchmark's spans around calls into the program's layers: host
    seconds per apply (no sync), and, while a profiler runs, a
    record_function per span for the trace."""

    def __init__(self, torch):
        self.torch = torch
        self.profiling = False
        self.applies = []

    def ctx(self, name):
        if self.profiling:
            return self.torch.profiler.record_function(
                tracemod.SPAN_PREFIX + name)
        return contextlib.nullcontext()

    def install(self, S):
        """Wrap the preconditioner's apply and the Krylov loop that the
        refinement solve calls; returns the undo."""
        from hymls_tpu_torch.solvers import krylov
        P = S.precond
        apply_fn, gmres = P.apply_fn, krylov.gmres

        def timed_apply(*a, **kw):
            with self.ctx("apply"):
                t0 = time.perf_counter()
                out = apply_fn(*a, **kw)
                self.applies.append(time.perf_counter() - t0)
            return out

        def spanned_gmres(*a, **kw):
            with self.ctx("krylov"):
                return gmres(*a, **kw)

        P.apply_fn = timed_apply
        krylov.gmres = spanned_gmres

        def undo():
            del P.apply_fn
            krylov.gmres = gmres
        return undo


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def own_relres(S) -> float:
    """The relative residual the program reports for its last solve."""
    res = getattr(S, "_last_result", None)
    return float(res.relres) if res is not None else float("nan")


def factor(S, K, how: str) -> None:
    """Factor K as the mix says: `compute` cold, `recompute` warm (the
    IR solver's compute with the preconditioner's recompute in its
    place)."""
    if how == "compute":
        S.compute(K)
    else:
        S.precond.recompute(K)
        S.solver.set_matrix(K)
        S.op64.set_values(K.tocsr().data)


def make_solver(cfg: dict, fam: dict, pool, device):
    """The program under test, built on K(theta) of the configuration."""
    from hymls_tpu_torch import Params
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    return IterativeRefinementSolver(
        pool.matrix(fam["theta"]), Params(copy.deepcopy(cfg["params"])),
        testvector=fam["testvector"], device=device)


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        wrap: Optional[Callable] = None) -> dict:
    """One run; returns the result object.  `wrap(S)`, for tests only,
    puts another object with S's `compute`, `solve` and `num_iter` in the
    program's place."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    c = load_cell(root, workload)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    marks = [("start", t_start), ("torch", time.perf_counter())]
    fam = inputs.family(c.bench_dir, c.cfg)
    pool = inputs.Pool(fam, c.mix, seed)
    marks.append(("inputs", time.perf_counter()))
    S = make_solver(c.cfg, fam, pool, device)
    marks.append(("solver", time.perf_counter()))
    plan = getattr(S.precond, "plan_seconds", None)
    if wrap is not None:
        S = wrap(S)
    if pool.factor == "setup":
        factor(S, pool.setup_matrix(), "compute")
        sync()
    marks.append(("compute", time.perf_counter()))

    spans = Spans(torch)

    def call(k, fence=None):
        """One call of the mix on input k: its factorization, where the
        mix has one in each call, then its solves; returns
        [(i, x, inner iterations, the program's relres)] per solve.  With
        a dict `fence`, the factorization and the solves each timed
        between synchronizes into it."""
        if pool.factor != "setup":
            with spans.ctx("compute"):
                t0 = time.perf_counter()
                factor(S, pool.mat(k), pool.factor)
                if fence is not None:
                    sync()
                    fence["compute_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = []
        for i in range(pool.solves):
            with spans.ctx("solve"):
                x = S.solve(pool.rhs(k, i))
            out.append((i, x, int(S.num_iter), own_relres(S)))
        sync()
        if fence is not None:
            fence["solve_s"] = time.perf_counter() - t0
        return out

    # set-up's warm calls: every shape of the window, twice
    for k in range(2):
        t0 = time.perf_counter()
        call(k)
        t_warm = time.perf_counter() - t0
    n_trace = int(c.mix["trace_calls"]) if trace else 0
    marks.append(("warm", time.perf_counter()))
    _log(f"portbench: {workload} seed {seed}: n={fam['n']}, plan "
         f"{plan if plan is None else round(plan, 4)} s, last warm call "
         f"{t_warm:.4f} s; set-up s: " +
         ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                   for a, b in zip(marks, marks[1:])))

    undo = spans.install(S) if trace else None
    host = HostLoad()
    calls, answers = [], []
    k = 2
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    deadline = t_win + seconds
    while True:
        rec = {}
        c0 = time.thread_time()
        t0 = time.perf_counter()
        out = call(k, rec if trace else None)
        t1 = time.perf_counter()
        rec.update(k=k, s=t1 - t0, cpu_s=time.thread_time() - c0,
                   iters=sum(o[2] for o in out), relres=[o[3] for o in out])
        calls.append(rec)
        answers += [(k, i, x) for i, x, _, _ in out]
        k += 1
        if t1 >= deadline:
            break
    window_s = t1 - t_win
    host.close()
    applies = list(spans.applies)

    # the traced stretch: a few more calls under the profiler, last,
    # since the profiler slows what runs after it
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        spans.profiling = True
        with profile(activities=acts) as prof:
            for j in range(k, k + n_trace):
                with spans.ctx("call"):
                    answers += [(j, i, x) for i, x, _, _ in call(j)]
        spans.profiling = False
        undo()
        tr = tracemod.from_profiler(prof)
        del prof

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": int(c.cell["chips"]) if cuda else 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                if cuda else 0}
    bad = banned_modules()
    if bad:
        raise SystemExit(f"portbench: modules loaded that may not be: {bad}")

    # the check: every answer of the window and the traced stretch,
    # judged by the reference on the host, with the program freed
    X = torch.stack([x for _, _, x in answers]).cpu().numpy()
    keys = [(j, i) for j, i, _ in answers]
    del answers, S
    if cuda:
        torch.cuda.empty_cache()
    limit = float(c.cfg["params"]["Solver"]["Iterative Solver"]
                  ["Convergence Tolerance"])
    res = np.array([ref.relres(pool.mat(j), X[a], pool.rhs(j, i))
                    for a, (j, i) in enumerate(keys)])
    own = np.array([r for c_ in calls for r in c_["relres"]], dtype=float)
    ok = np.isfinite(own)
    gap = float(np.max(np.abs(res[:own.size][ok] / own[ok] - 1))) \
        if ok.any() else float("nan")
    failed = int(np.sum(~(res <= limit)))
    compared = {"relres_max": {"value": float(np.max(res)), "limit": limit},
                "failed_answers": {"value": failed, "limit": 0}}

    durations = [r["s"] for r in calls]
    metrics = {}
    if not trace:
        for m in c.end_to_end:
            v = setup_s if m["name"] == "setup_s" else end_to_end(
                m["name"], c.mix["call"], window_s, durations)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        seen = SimpleNamespace(
            calls=calls, applies_s=applies, trace=tr, window_s=window_s,
            device_kind=dev_info["kind"], cuda=cuda,
            k1={"n": fam["n"], "bands": kernels.dia_bands(
                fam["indptr"], fam["indices"])})
        for m in c.per_layer:
            v = reader(c.bench_dir, m["name"])(seen)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None and tr.device:
            dev_info["busy_s"] = tracemod.busy_ns(tr.device, tr.lo,
                                                  tr.hi) * 1e-9
            dev_info["window_s"] = tr.window_ns * 1e-9
    out = {"correct": bool(failed == 0 and len(keys) > 0),
           "attempted": len(keys), "failed": failed, "metrics": metrics,
           "device": dev_info}
    if tr is not None and tr.device:
        out["breakdown"] = {
            "device_ops": tracemod.top_ops(tr),
            "idle_gaps": sorted(([k_, v] for k_, v in
                                 tracemod.idle_by_span(tr).items()),
                                key=lambda kv: -kv[1])[:10]}
    _log(f"portbench: {len(calls)} calls in a {window_s:.4f} s window, "
        f"setup {setup_s:.4f} s, memory peak "
        f"{dev_info['memory_peak_bytes']} B; inner iterations per call "
        f"{[r['iters'] for r in calls]}; call s quartiles "
        f"{[round(stats.percentile(durations, q), 4) for q in (0, 25, 50, 75, 100)]}"
        f"; call s {[round(d, 3) for d in durations]}"
        f"; host thread CPU s {[round(r['cpu_s'], 3) for r in calls]}, "
        f"{sum(r['cpu_s'] for r in calls) / sum(durations):.4f} of the "
        f"calls' time; garbage collection {host.gc_s:.4f} s"
        f"; the reference's relres against the program's own: largest "
        f"relative gap {gap:.3e}")
    out["compared"] = compared
    return out
