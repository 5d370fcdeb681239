"""Plan: MB of the preconditioner's plans on the device per construction,
from the program's own counters (`hymls.plan.device_bytes` over the
constructions, `hymls.plan.builds` plus `hymls.plan.cache_loads`), over
the run.  A program without these counters reads nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    made = c.get("hymls.plan.builds", 0) + c.get("hymls.plan.cache_loads", 0)
    return 1e-6 * c.get("hymls.plan.device_bytes", 0) / made if made \
        else None
