"""V-cycle apply: the share of preconditioner applies replayed from a
captured CUDA graph, from the program's own counters
(`hymls.apply.graph_replays` over it plus `hymls.apply.eager`), over
every apply of the run: its set-up's warm calls, the window and the
traced stretch.  A program without these counters reads nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    replays = c.get("hymls.apply.graph_replays", 0)
    applies = replays + c.get("hymls.apply.eager", 0)
    return replays / applies if applies else None
