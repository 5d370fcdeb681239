"""Krylov: mean inner f32 iterations per call of the window, from the
solver's count (`num_iter`)."""


def read(rec):
    xs = [c["iters"] for c in rec.calls]
    return sum(xs) / len(xs) if xs else None
