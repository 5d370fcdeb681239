"""Factorization: mean ms of `compute(K_k)` per call of the window, host
clock between synchronizes."""


def read(rec):
    xs = [c["compute_s"] for c in rec.calls if "compute_s" in c]
    return 1e3 * sum(xs) / len(xs) if xs else None
