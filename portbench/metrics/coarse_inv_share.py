"""Coarse solve: the share of coarse factorizations held as an explicit
inverse, from the program's own counters (`hymls.coarse.inverse` over it
plus `hymls.coarse.lu`), over every factorization of the run: its
set-up's, the window's and the traced stretch's.  A program without
these counters reads nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    inverse = c.get("hymls.coarse.inverse", 0)
    factors = inverse + c.get("hymls.coarse.lu", 0)
    return inverse / factors if factors else None
