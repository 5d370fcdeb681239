"""Reading a torch.profiler trace: the device's intervals, the
benchmark's host spans, the busy union and the idle gaps.

Times are nanoseconds on the profiler's clock, which it shares between
host and device events.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "portbench."
#: host spans, innermost first: a device gap is charged to the innermost
#: span the host was in at the gap's midpoint
SPAN_ORDER = ("apply", "krylov", "compute", "solve", "call")


@dataclass
class Trace:
    """Device intervals (start, end, name) and host spans by name, and
    the traced window [lo, hi]: from the first traced call's start to
    the last one's end."""
    device: List[Tuple[int, int, str]]
    spans: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)
    lo: int = 0
    hi: int = 0

    @property
    def window_ns(self) -> int:
        return self.hi - self.lo


def _times(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        s, d = e.start_ns(), e.duration_ns()
    else:
        s, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
    return s, s + d


def from_profiler(prof) -> Optional[Trace]:
    """The Trace of a finished torch.profiler.profile; None when it holds
    no traced call."""
    from torch.autograd import DeviceType
    device, spans = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = _times(e)
        if name.startswith(SPAN_PREFIX):
            if e.device_type() == DeviceType.CPU:
                spans.setdefault(name[len(SPAN_PREFIX):], []).append((s, t))
        elif e.device_type() == DeviceType.CUDA:
            device.append((s, t, name))
    calls = spans.get("call")
    if not calls:
        return None
    for v in spans.values():
        v.sort()
    device.sort()
    return Trace(device, spans, min(c[0] for c in calls),
                 max(c[1] for c in calls))


def merged(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out: List[List[int]] = []
    for iv in sorted(intervals):
        s, t = max(iv[0], lo), min(iv[1], hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of the intervals inside [lo, hi]."""
    return sum(t - s for s, t in merged(intervals, lo, hi))


def gaps(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, t in merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = t
    if hi > at:
        out.append((at, hi))
    return out


def _inside(spans: List[Tuple[int, int]], starts: List[int], x: int) -> bool:
    i = bisect.bisect_right(starts, x) - 1
    # spans of one name do not nest, so the last one starting at or
    # before x is the only one that can hold it
    return i >= 0 and spans[i][1] >= x


def idle_by_span(tr: Trace) -> Dict[str, float]:
    """Idle device seconds of the traced window, by the innermost host
    span at each gap's midpoint ('host' outside every span)."""
    starts = {k: [s for s, _ in v] for k, v in tr.spans.items()}
    out: Dict[str, float] = {}
    for s, t in gaps(tr.device, tr.lo, tr.hi):
        mid = (s + t) // 2
        label = next((k for k in SPAN_ORDER if k in tr.spans and
                      _inside(tr.spans[k], starts[k], mid)), "host")
        out[label] = out.get(label, 0.0) + (t - s) * 1e-9
    return out


def top_ops(tr: Trace, k: int = 10, width: int = 96):
    """The k device operations of most total time in the window, as
    [name, seconds], names cut to `width` characters."""
    tot: Dict[str, float] = {}
    for s, t, name in tr.device:
        s, t = max(s, tr.lo), min(t, tr.hi)
        if t > s:
            tot[name[:width]] = tot.get(name[:width], 0.0) + (t - s) * 1e-9
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]
