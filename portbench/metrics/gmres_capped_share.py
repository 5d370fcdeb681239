"""Krylov: the share of inner GMRES solves that stopped at their
iteration cap above their tolerance, from the program's own counters
(`hymls.gmres.capped` over `hymls.refine.passes`: each refinement pass
runs one inner solve), over every solve of the run: its set-up's warm
calls, the window and the traced stretch.  A program that counts capped
solves adds to `hymls.gmres.capped` at every solve (0 where it met its
tolerance), so the counter exists there; a program without it reads
nothing."""
import sys


def read(rec):
    timings = sys.modules.get("hymls_tpu_torch.utils.timings")
    snapshot = getattr(timings, "counter_snapshot", None)
    if snapshot is None:
        return None
    c = snapshot()
    passes = c.get("hymls.refine.passes", 0)
    if "hymls.gmres.capped" not in c or not passes:
        return None
    return c["hymls.gmres.capped"] / passes
