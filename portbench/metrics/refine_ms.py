"""Refinement loop: mean ms of `solve(b_k)` per call of the window, host
clock between synchronizes."""


def read(rec):
    xs = [c["solve_s"] for c in rec.calls if "solve_s" in c]
    return 1e3 * sum(xs) / len(xs) if xs else None
