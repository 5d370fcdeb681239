"""Device: the share of the traced stretch, in %, in which no kernel,
copy or set ran on the card (1 - union of device intervals / window)."""
from portbench import trace


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device or tr.window_ns <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_ns(tr.device, tr.lo, tr.hi)
                    / tr.window_ns)
