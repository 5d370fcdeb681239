"""V-cycle apply: the share of the generic program's static gathers that
ran the hand-written sentinel gather kernel, from the program's own
counters (`hymls.gather.kernel` over it plus `hymls.gather.plain`), over
every gather of the run: its plan build, factorizations, graph captures
and eager applies (a replayed graph adds nothing).  A program without
these counters reads nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    kernel = c.get("hymls.gather.kernel", 0)
    gathers = kernel + c.get("hymls.gather.plain", 0)
    return kernel / gathers if gathers else None
