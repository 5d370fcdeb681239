"""Krylov: the share of GMRES iterations replayed from a captured CUDA
graph, from the program's own counters (`hymls.gmres.graph_replays`
over it plus `hymls.gmres.eager`), over every iteration of the run: its
set-up's warm calls, the window and the traced stretch.  A program
without these counters reads nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    replays = c.get("hymls.gmres.graph_replays", 0)
    iters = replays + c.get("hymls.gmres.eager", 0)
    return replays / iters if iters else None
