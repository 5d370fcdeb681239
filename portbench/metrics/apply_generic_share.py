"""V-cycle apply: the share of preconditioner applies that ran the
generic gather program, from the program's own counters
(`hymls.apply.generic` over it plus `hymls.apply.structured`), over
every apply of the run: its set-up's warm calls, the window and the
traced stretch.  A program without these counters reads nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    generic = c.get("hymls.apply.generic", 0)
    applies = generic + c.get("hymls.apply.structured", 0)
    return generic / applies if applies else None
