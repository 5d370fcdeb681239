#!/usr/bin/env python3
"""The program's own spans and counters in a traced stretch: which of
its layers launched each kernel, copy and set on the card, where the
card idles, and how often the host waits for it.

The port opens a profiler range at each of its layer boundaries
(hymls_tpu_torch/utils/timings.py `prof`, names `hymls.*`) and keeps
counters (`counter_snapshot()`).  A device event is charged to the
innermost program range that holds the host call that launched it: the
runtime or driver call with the device event's correlation id, else the
host operation its linked correlation id names.  The card runs behind
the host, so an overlap of device and host times would charge the wrong
layer.  Device work with no launch in the trace stays uncharged.

Run as a script, it is `run.py --trace 1` with these readings added to
the result line, under the names the benchmark would give them
(`<metric>.<traffic>`), and the device seconds by program span and the
idle gaps by program span logged on standard error:

    python3 portbench/spans.py --workload <name> --seed <n> --seconds <s>

The counters are read around the measured window and around the traced
stretch.  The benchmark's own readers run as they do under `run.py`.
"""
from __future__ import annotations

import bisect
import os
import sys
import time

T_START = time.perf_counter()

from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT

from portbench import trace as tracemod  # noqa: E402

PREFIX = "hymls."
#: the label of device work whose launch is not in the trace
NO_LAUNCH = "(no launch)"
#: the label of device work launched outside every program span
OUTSIDE = "(outside the program's spans)"
#: host events of the profiler itself: a call inside one is not the
#: program's
PROFILER_OPS = ("Activity Buffer Request",)
#: runtime and driver calls that copy and wait for the copy
BLOCKING_COPIES = ("cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D",
                   "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2",
                   "cuMemcpyHtoD", "cuMemcpyHtoD_v2")


def is_runtime(name: str) -> bool:
    """Whether a host event is a CUDA runtime (`cuda*`) or driver
    (`cu*`) call."""
    return name.startswith("cuda") or (name.startswith("cu") and
                                       name[2:3].isupper())


def is_sync(name: str) -> bool:
    """Whether a runtime or driver call makes the host wait for the
    card."""
    return "Synchronize" in name or name in BLOCKING_COPIES


@dataclass
class ProgramTrace:
    """The program's ranges (start, end, name) on the host, the host
    start of each launch by correlation id (`launches`: runtime and
    driver calls; `ops`: other host operations, by their own id), each
    synchronizing call (host start, "<call> in <host op>"), the device
    events (start, end, name, correlation id, linked correlation id),
    and the traced window [lo, hi]."""
    spans: List[Tuple[int, int, str]]
    launches: Dict[int, int] = field(default_factory=dict)
    ops: Dict[int, int] = field(default_factory=dict)
    syncs: List[Tuple[int, str]] = field(default_factory=list)
    device: List[Tuple[int, int, str, int, int]] = field(default_factory=list)
    lo: int = 0
    hi: int = 0

    def __post_init__(self):
        self.spans.sort()
        self.syncs.sort()
        self._segs = segments(self.spans)
        self._starts = [s for s, _, _ in self._segs]

    def innermost(self, x: int) -> Optional[str]:
        """The innermost program span that holds host time x, or None."""
        i = bisect.bisect_right(self._starts, x) - 1
        if i >= 0 and x < self._segs[i][1]:
            return self._segs[i][2]
        return None

    def launch_time(self, corr: int, linked: int) -> Optional[int]:
        """The host time at which the device event with these ids was
        launched, or None."""
        t = self.launches.get(corr)
        return self.ops.get(linked) if t is None and linked else t


def segments(spans) -> List[Tuple[int, int, str]]:
    """The disjoint stretches (start, end, name) of properly nested
    spans (start, end, name), each labelled with the innermost span
    over it."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []
    at = 0

    def upto(t):
        nonlocal at
        if stack and t > at:
            out.append((at, t, stack[-1][1]))
        at = max(at, t)

    for s, t, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        while stack and stack[-1][0] <= s:
            upto(stack[-1][0])
            stack.pop()
        upto(s)
        stack.append((t, name))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    return out


def program_trace(prof, lo: int, hi: int) -> ProgramTrace:
    """The ProgramTrace of a finished torch.profiler.profile over the
    traced window [lo, hi]."""
    from torch.autograd import DeviceType
    spans, launches, ops, syncs, device = [], {}, {}, [], []
    op_names: Dict[int, str] = {}
    calls = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = tracemod._times(e)
        if e.device_type() == DeviceType.CUDA:
            if not (hasattr(e, "is_user_annotation") and
                    e.is_user_annotation()):
                device.append((s, t, name, e.correlation_id(),
                               e.linked_correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((s, t, name))
            ops[e.correlation_id()] = s
        elif is_runtime(name):
            launches[e.correlation_id()] = s
            if is_sync(name):
                calls.append((s, name, e.linked_correlation_id()))
        else:
            ops[e.correlation_id()] = s
            op_names[e.correlation_id()] = name
    for s, name, linked in calls:
        op = op_names.get(linked, "?")
        if op not in PROFILER_OPS:
            syncs.append((s, f"{name} in {op}"))
    device.sort()
    return ProgramTrace(spans, launches, ops, syncs, device, lo, hi)


def charged(pt: ProgramTrace):
    """(span, device event name, seconds) of each device event inside
    [lo, hi], its span the innermost program span of its launch, else
    NO_LAUNCH or OUTSIDE."""
    for s, t, name, corr, linked in pt.device:
        s, t = max(s, pt.lo), min(t, pt.hi)
        if t <= s:
            continue
        at = pt.launch_time(corr, linked)
        key = NO_LAUNCH if at is None else (pt.innermost(at) or OUTSIDE)
        yield key, name, (t - s) * 1e-9


def device_by_span(pt: ProgramTrace) -> Dict[str, float]:
    """Device seconds inside [lo, hi] by the innermost program span of
    their launch; NO_LAUNCH and OUTSIDE for the rest."""
    out: Dict[str, float] = {}
    for key, _, sec in charged(pt):
        out[key] = out.get(key, 0.0) + sec
    return out


def ops_by_span(pt: ProgramTrace, k: int = 3, width: int = 72):
    """{span: [[device event name, seconds], ...]}: each span's k device
    events of most time, names cut to `width` characters."""
    tot: Dict[str, Dict[str, float]] = {}
    for key, name, sec in charged(pt):
        d = tot.setdefault(key, {})
        d[name[:width]] = d.get(name[:width], 0.0) + sec
    return {key: _top(d, k) for key, d in tot.items()}


def syncs_by_span(pt: ProgramTrace) -> Dict[str, Dict[str, int]]:
    """Synchronizing calls inside [lo, hi] by their innermost program
    span (OUTSIDE for the rest), counted by call and host op."""
    out: Dict[str, Dict[str, int]] = {}
    for x, what in pt.syncs:
        if pt.lo <= x <= pt.hi:
            d = out.setdefault(pt.innermost(x) or OUTSIDE, {})
            d[what] = d.get(what, 0) + 1
    return out


def _under(name: str, root: str) -> bool:
    return name == root or name.startswith(root + ".")


def n_spans(pt: ProgramTrace, name: str) -> int:
    """The number of spans `name` that start inside [lo, hi]."""
    return sum(1 for s, _, n in pt.spans if n == name and
               pt.lo <= s <= pt.hi)


def syncs_inside(pt: ProgramTrace, name: str) -> int:
    """The synchronizing calls inside any span `name` in [lo, hi]."""
    holds = tracemod.merged(
        [(s, t) for s, t, n in pt.spans if n == name], pt.lo, pt.hi)
    starts = [s for s, _ in holds]
    k = 0
    for x, _ in pt.syncs:
        i = bisect.bisect_right(starts, x) - 1
        k += i >= 0 and x <= holds[i][1]
    return k


def per_apply_us(pt: ProgramTrace, root: str) -> Optional[float]:
    """Device us charged to `root` and the spans under it, per
    `hymls.apply` span; None without device work (a CPU run)."""
    n = n_spans(pt, PREFIX + "apply")
    if not n or not pt.device:
        return None
    sec = sum(v for k, v in device_by_span(pt).items() if _under(k, root))
    return 1e6 * sec / n


def apply_device_us(pt: ProgramTrace) -> Optional[float]:
    """V-cycle apply: device us per apply, its levels and coarse solve
    included."""
    return per_apply_us(pt, PREFIX + "apply")


def coarse_device_us(pt: ProgramTrace) -> Optional[float]:
    """Coarse solve: device us of `hymls.apply.coarse` per apply."""
    return per_apply_us(pt, PREFIX + "apply.coarse")


def syncs_per_iter(pt: ProgramTrace, iters: int) -> Optional[float]:
    """Krylov: synchronizing calls inside `hymls.refine` per inner
    iteration (`iters`, the counter `hymls.gmres.iters` over the traced
    stretch)."""
    if not iters or not pt.device or not n_spans(pt, PREFIX + "refine"):
        return None
    return syncs_inside(pt, PREFIX + "refine") / iters


def factor_syncs(pt: ProgramTrace) -> Optional[float]:
    """Factorization: synchronizing calls per `hymls.compute` span."""
    n = n_spans(pt, PREFIX + "compute")
    if not n or not pt.device:
        return None
    return syncs_inside(pt, PREFIX + "compute") / n


def refine_passes(delta: Dict[str, int]) -> Optional[float]:
    """Refinement loop: passes per refinement solve, from a difference
    of two counter snapshots."""
    solves = delta.get(PREFIX + "refine.solves", 0)
    return delta.get(PREFIX + "refine.passes", 0) / solves if solves \
        else None


def idle_by_span(tr, pt: ProgramTrace) -> Dict[str, float]:
    """`trace.idle_by_span` with each gap inside a program span charged
    to the innermost one at its midpoint; the rest keep the benchmark's
    own labels."""
    starts = {k: [s for s, _ in v] for k, v in tr.spans.items()}
    out: Dict[str, float] = {}
    for s, t in tracemod.gaps(tr.device, tr.lo, tr.hi):
        mid = (s + t) // 2
        label = pt.innermost(mid) or next(
            (k for k in tracemod.SPAN_ORDER if k in tr.spans and
             tracemod._inside(tr.spans[k], starts[k], mid)), "host")
        out[label] = out.get(label, 0.0) + (t - s) * 1e-9
    return out


def diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    """after - before, counter by counter."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _snapshot() -> Dict[str, int]:
    from hymls_tpu_torch.utils import timings
    return timings.counter_snapshot()


def _top(d: Dict[str, float], k: int = 10):
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


class Capture:
    """Hooks into one `harness.run`: counter snapshots at the window's
    start and end (the harness opens and closes its HostLoad there) and
    at the end of the traced stretch, and the profile itself."""

    def __init__(self):
        self.marks: Dict[str, Dict[str, int]] = {}
        self.pt: Optional[ProgramTrace] = None
        self.tr = None

    def install(self, harness):
        """Put the hooks in; returns the undo."""
        cap, host_load, read = self, harness.HostLoad, tracemod.from_profiler

        class Window(host_load):
            def __init__(self):
                cap.marks["window_start"] = _snapshot()
                super().__init__()

            def close(self):
                super().close()
                cap.marks["window_end"] = _snapshot()

        def from_profiler(prof):
            cap.marks["trace_end"] = _snapshot()
            cap.tr = read(prof)
            if cap.tr is not None:
                cap.pt = program_trace(prof, cap.tr.lo, cap.tr.hi)
            return cap.tr

        harness.HostLoad, tracemod.from_profiler = Window, from_profiler

        def undo():
            harness.HostLoad, tracemod.from_profiler = host_load, read
        return undo

    def metrics(self, traffic: str) -> Dict[str, Tuple[float, str]]:
        """The five readings by their names in a cell of `traffic`."""
        m = self.marks
        out = {}
        window = diff(m["window_end"], m["window_start"])
        traced = diff(m["trace_end"], m["window_end"])
        vals = {"refine_passes": (refine_passes(window), "passes")}
        if self.pt is not None:
            pt = self.pt
            vals.update(
                apply_device_us=(apply_device_us(pt), "us"),
                coarse_device_us=(coarse_device_us(pt), "us"),
                syncs_per_iter=(syncs_per_iter(
                    pt, traced.get(PREFIX + "gmres.iters", 0)), "syncs/iter"),
                factor_syncs=(factor_syncs(pt), "syncs"))
        for k, (v, unit) in vals.items():
            if v is not None:
                out[f"{k}.{traffic}"] = (v, unit)
        return out


def annotate(out: dict, cap: Capture, traffic: str) -> None:
    """Add the readings of `cap` to the result object `out` of its run,
    and its device seconds and idle gaps by program span to
    `out["breakdown"]`; log them, and the counters, on standard
    error."""
    for k, (v, unit) in cap.metrics(traffic).items():
        out["metrics"][k] = {"value": v, "unit": unit}
    m = cap.marks
    _log(f"portbench: counters over the window "
         f"{diff(m['window_end'], m['window_start'])}, over the traced "
         f"stretch {diff(m['trace_end'], m['window_end'])}")
    if cap.pt is None or not cap.pt.device:
        return
    by_span = device_by_span(cap.pt)
    bd = out.setdefault("breakdown", {})
    bd["device_by_program_span"] = _top(by_span)
    bd["idle_gaps_by_program_span"] = _top(idle_by_span(cap.tr, cap.pt))
    _log(f"portbench: device s by innermost program span "
         f"{bd['device_by_program_span']}; uncharged "
         f"{by_span.get(NO_LAUNCH, 0.0):.6f} s of {sum(by_span.values()):.6f}"
         f" s; idle gaps by innermost program span "
         f"{bd['idle_gaps_by_program_span']}")
    _log(f"portbench: top device events by program span "
         f"{ops_by_span(cap.pt)}; synchronizing calls by program span "
         f"{syncs_by_span(cap.pt)}")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    from portbench import harness, run
    cap = Capture()
    undo = cap.install(harness)
    inner = harness.run

    def traced_run(root, workload, *a, **kw):
        out = inner(root, workload, *a, **kw)
        annotate(out, cap, harness.load_cell(root, workload).cell["traffic"])
        return out

    harness.run = traced_run
    run.T_START = T_START
    try:
        return run.main(list(argv if argv is not None else sys.argv[1:])
                        + ["--trace", "1"])
    finally:
        harness.run = inner
        undo()


if __name__ == "__main__":
    sys.exit(main())
