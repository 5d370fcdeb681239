"""Refinement loop: f64 refinement passes per refinement solve, from the
program's own counters (`hymls.refine.passes` over
`hymls.refine.solves`), over every solve of the run: its set-up's warm
calls, the window and the traced stretch.  A program without counters
reads nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    solves = c.get("hymls.refine.solves", 0)
    return c.get("hymls.refine.passes", 0) / solves if solves else None
