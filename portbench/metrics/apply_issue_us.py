"""V-cycle apply: mean host us from entry to return of each
preconditioner apply of the window, with no synchronize."""


def read(rec):
    xs = rec.applies_s
    return 1e6 * sum(xs) / len(xs) if xs else None
