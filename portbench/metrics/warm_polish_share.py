"""Factorization: the share of warm-started dense inverses whose gate
let the previous inverse be polished rather than inverted afresh, from
the program's own counters (`hymls.warm.polish` over it plus
`hymls.warm.fresh`), over every warm recompute of the run: its set-up's
warm calls, the window and the traced stretch.  A program without these
counters, or a run with no warm recompute, reads nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    polish = c.get("hymls.warm.polish", 0)
    calls = polish + c.get("hymls.warm.fresh", 0)
    return polish / calls if calls else None
