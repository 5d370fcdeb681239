"""Coarse solve: the order of the dense coarse system, per coarse
factorization, from the program's own counters (`hymls.coarse.unknowns`
over `hymls.coarse.inverse` plus `hymls.coarse.lu`), over every
factorization of the run.  A program without these counters reads
nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    factors = c.get("hymls.coarse.inverse", 0) + c.get("hymls.coarse.lu", 0)
    if "hymls.coarse.unknowns" not in c or not factors:
        return None
    return c["hymls.coarse.unknowns"] / factors
