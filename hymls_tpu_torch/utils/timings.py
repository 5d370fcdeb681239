"""Hierarchical wall-clock timers (reference Tools::StartTiming /
StopTiming / PrintTiming, src/HYMLS_Tools.cpp:345-438,549), scope-based
profiling with verbosity levels doubling as an indented function trace
(reference HYMLS_PROF{,2,3} macros, src/HYMLS_Macros.hpp:55-129), a
host+device memory ledger (reference HYMLS_Malloc.cpp +
Tools::StartMemory/PrintMemUsage), with a CUDA synchronize fence for
device work, and event counters.

`prof(label, level)` is the port's one span primitive.  While a
torch.profiler runs, every scope, at any level, is a profiler range
named `label` on the profiler's clock, so the kernels, copies and
runtime calls it launches nest inside it in the trace.  The level gates
only the host-clock table of `print_timing` and the function trace.
With no profiler running and the level above HYMLS_TIMING_LEVEL, a
scope costs three checks and returns one shared object that does
nothing.  `count(name, n)` adds to an always-on integer counter;
`counter_snapshot()` reads them all and `print_timing()` lists them.

Environment knobs (mirroring the reference's compile-time flags):
  HYMLS_TIMING_LEVEL    0-3: scopes with level > this are not timed on
                        the host clock (reference HYMLS_TIMING_LEVEL);
                        default 1
  HYMLS_FUNCTION_TRACING  "1": print indented ENTER/LEAVE lines for
                        every prof scope (reference
                        HYMLS_FUNCTION_TRACING / HYMLS_DEBUGGING)
"""
from __future__ import annotations

import functools
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler


_REGISTRY = []

TIMING_LEVEL = int(os.environ.get("HYMLS_TIMING_LEVEL", "1"))


def sync(tree):
    """Wait until the work behind every CUDA tensor in `tree` is done;
    returns `tree`.  THE timing fence for this package.

    Walks dicts, lists and tuples; synchronizes the CUDA device of each
    CUDA tensor it finds (once per device) and does nothing for CPU
    tensors and other leaves.  A CUDA kernel returns to the host before
    the card finishes it, so a host clock read without this fence
    measures the enqueue, not the work.
    """
    import torch
    devices = set()
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.is_cuda:
            devices.add(t.device)
    for d in devices:
        torch.cuda.synchronize(d)
    return tree


FUNCTION_TRACING = os.environ.get("HYMLS_FUNCTION_TRACING", "") == "1"
_TRACE_DEPTH = [0]


class Timer:
    """Label-keyed accumulating timers with call counts."""

    def __init__(self, name: str = ""):
        self.name = name
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        _REGISTRY.append(self)

    @contextmanager
    def scope(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _cuda_fence()
            dt = time.perf_counter() - t0
            self._totals[label] += dt
            self._counts[label] += 1

    def total(self, label: str) -> float:
        return self._totals.get(label, 0.0)

    def count(self, label: str) -> int:
        return self._counts.get(label, 0)

    def report(self) -> str:
        lines = [f"Timer report [{self.name}]"]
        for label in sorted(self._totals, key=self._totals.get,
                            reverse=True):
            lines.append(f"  {label:40s} {self._totals[label]:10.4f}s "
                         f"({self._counts[label]} calls)")
        return "\n".join(lines)

    def print_report(self):
        print(self.report())


def _cuda_fence():
    """Wait for every CUDA device this process has used; nothing when
    CUDA was never initialized (a CPU run stays off the card)."""
    import torch
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


_PROF_TIMER = None


def _prof_timer() -> "Timer":
    global _PROF_TIMER
    if _PROF_TIMER is None:
        _PROF_TIMER = Timer("prof")
    return _PROF_TIMER


class _Off:
    """The scope of a `prof` call while nothing records it: one shared
    instance that enters and leaves doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        return False


_OFF = _Off()


class _Scope:
    """A recording `prof` scope: a profiler range while a profiler runs,
    the host-clock table's row when `timed`, the function trace's two
    lines when HYMLS_FUNCTION_TRACING is on."""
    __slots__ = ("label", "timed", "rf", "t0")

    def __init__(self, label: str, timed: bool):
        self.label = label
        self.timed = timed
        self.rf = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            # a range of FUNCTION scope: unlike record_function's user
            # scope it adds no device-side annotation event to the
            # trace, only the host range the launches nest in
            self.rf = _RecordFunctionFast(self.label)
            self.rf.__enter__()
        if FUNCTION_TRACING:
            print("  " * _TRACE_DEPTH[0] + f">> {self.label}",
                  file=sys.stderr)
            _TRACE_DEPTH[0] += 1
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, typ, val, tb):
        dt = time.perf_counter() - self.t0
        if self.timed:
            t = _prof_timer()
            t._totals[self.label] += dt
            t._counts[self.label] += 1
        if FUNCTION_TRACING:
            _TRACE_DEPTH[0] -= 1
            print("  " * _TRACE_DEPTH[0] + f"<< {self.label} ({dt:.4f}s)",
                  file=sys.stderr)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def prof(label: str, level: int = 1):
    """Scope with a verbosity level (the role of the reference's
    HYMLS_PROF/HYMLS_PROF2/HYMLS_PROF3 macros,
    src/HYMLS_Macros.hpp:55-129): a profiler range named `label`
    whenever a torch.profiler runs, whatever the level; timed on the
    host clock into `print_timing`'s table when `level` <=
    HYMLS_TIMING_LEVEL; an indented function trace line pair when
    HYMLS_FUNCTION_TRACING=1.  With none of the three, it returns one
    shared object that does nothing.  No scope synchronizes the card:
    its host-clock time is the enqueue, not the device work."""
    timed = level <= TIMING_LEVEL
    if not (timed or FUNCTION_TRACING
            or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Scope(label, timed or FUNCTION_TRACING)


def profiled(label: str = None, level: int = 1):
    """Decorator form of `prof` (the reference puts HYMLS_PROF at the
    top of every traced function)."""
    def deco(fn):
        name = label or f"{fn.__module__.split('.')[-1]}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with prof(name, level):
                return fn(*a, **k)
        return wrapper
    return deco


def print_timing() -> str:
    """Aggregated end-of-run timing table over every Timer created in
    the process (the role of the reference's Tools::PrintTiming,
    src/HYMLS_Tools.cpp:549, called at driver exit src/main.cpp:515):
    one row per '<timer>: <label>', sorted by total time."""
    rows = {}
    for t in _REGISTRY:
        for label, total in t._totals.items():
            key = f"{t.name}: {label}" if t.name else label
            tot, cnt = rows.get(key, (0.0, 0))
            rows[key] = (tot + total, cnt + t._counts[label])
    width = max([len(k) for k in rows] + [20])
    lines = ["=" * (width + 30),
             f"{'timer':{width}s} {'total':>10s} {'calls':>6s} {'avg':>10s}",
             "-" * (width + 30)]
    for key, (tot, cnt) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{key:{width}s} {tot:9.4f}s {cnt:6d} "
                     f"{tot / max(cnt, 1):9.4f}s")
    lines.append("=" * (width + 30))
    if _COUNTERS:
        cw = max(len(k) for k in _COUNTERS)
        lines.append(f"{'counter':{cw}s} {'count':>12s}")
        for name in sorted(_COUNTERS):
            lines.append(f"{name:{cw}s} {_COUNTERS[name]:12d}")
        lines.append("=" * (width + 30))
    return "\n".join(lines)


def reset_timing():
    """Clear the global timer registry (fresh aggregation window); the
    `prof` scopes start a new timer in it."""
    global _PROF_TIMER
    _REGISTRY.clear()
    _PROF_TIMER = None


#: event counters by name, always on (`count`)
_COUNTERS: Dict[str, int] = defaultdict(int)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _COUNTERS[name] += n


def counter_snapshot() -> Dict[str, int]:
    """Every counter's value now, as a new dict; the difference of two
    snapshots counts what happened between them."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    """Set every counter back to zero."""
    _COUNTERS.clear()


def _host_rss() -> tuple:
    """(current RSS bytes, peak RSS bytes) of this process."""
    cur = peak = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    cur = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
    except OSError:
        try:
            import resource
            peak = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
            cur = peak
        except Exception:
            pass
    return cur, peak


_MEM_MARKS: Dict[str, int] = {}
_MEM_DELTAS: Dict[str, tuple] = {}


def start_memory(label: str):
    """Bracket a phase for host-memory accounting (the role of
    Tools::StartMemory, src/HYMLS_Tools.cpp:438-450, backed by the
    LD-interposed ledger HYMLS_Malloc.cpp:10-48; here /proc RSS — same
    observable, no interposition needed in-process)."""
    _MEM_MARKS[label] = _host_rss()[0]


def stop_memory(label: str):
    """Close a `start_memory` bracket; records (delta, rss_at_stop)."""
    cur = _host_rss()[0]
    base = _MEM_MARKS.pop(label, cur)
    _MEM_DELTAS[label] = (cur - base, cur)


def host_memory_report() -> str:
    """Host process memory: current/peak RSS plus per-phase deltas from
    start_memory/stop_memory brackets (reference Tools::PrintMemUsage)."""
    cur, peak = _host_rss()
    lines = [f"  RSS {cur/1e6:.1f} MB, peak {peak/1e6:.1f} MB"]
    for label, (delta, at) in _MEM_DELTAS.items():
        lines.append(f"  phase {label:30s} {delta/1e6:+10.1f} MB "
                     f"(at {at/1e6:.1f} MB)")
    return "Host memory:\n" + "\n".join(lines)


def device_memory_report() -> str:
    """Per-card memory held by torch's CUDA allocator, now and at its
    peak (the role of the reference's LD-interposed malloc ledger,
    src/HYMLS_Malloc.cpp + Tools::PrintMemUsage).  Reads nothing, and
    initializes nothing, when this process has not used CUDA."""
    import torch
    if not torch.cuda.is_initialized():
        return "Device memory:\n  no CUDA device in use by this process"
    lines = []
    for i in range(torch.cuda.device_count()):
        used = torch.cuda.memory_allocated(i)
        peak = torch.cuda.max_memory_allocated(i)
        lines.append(f"  cuda:{i} ({torch.cuda.get_device_name(i)}): "
                     f"in use {used/1e6:.1f} MB, peak {peak/1e6:.1f} MB")
    return "Device memory:\n" + "\n".join(lines)
