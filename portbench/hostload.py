"""What the host thread did during the calls of a window, for the log:
its CPU seconds per call, and the seconds Python's garbage collector
ran.  The calls are issued by one host thread; where a call's wall time
follows its CPU time, the spread of the calls is the speed of the host's
CPU, not a wait.  No metric reads it."""
from __future__ import annotations

import gc
import time


class HostLoad:
    def __init__(self):
        self.gc_s = 0.0
        self._t = 0.0
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t

    def close(self) -> None:
        gc.callbacks.remove(self._on_gc)
