#!/usr/bin/env python3
"""The lower-precision control of a cell: the reference solve put in the
program's place, in float32 (the configuration states float64), judged as
a run judges the program.

    python3 portbench/control.py --workload <name> [--dtype float32|float64]

It solves every input of the mix's set (`inputs.Pool`: every seed takes
this same set, only in another order) with SuperLU in `dtype`, each
distinct matrix factored once, and prints one JSON line with the largest,
median and smallest relative residual and the configuration's limit.  The
control has to fail the limit on every input; float64 is the reference
itself, which has to pass.  NumPy and SciPy only: nothing of the program,
no card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT


def readings(root: str, workload: str, dtype: str = "float32") -> dict:
    """The control's relative residuals over the whole set of the cell's
    mix."""
    import numpy as np
    from portbench import harness, inputs
    from portbench.reference import solve as ref
    c = harness.load_cell(root, workload)
    fam = inputs.family(c.bench_dir, c.cfg)
    pool = inputs.Pool(fam, c.mix, 0)
    res = []
    sets = pool.every_input()
    for K, bs in sets:
        solve = ref.factor(K, np.dtype(dtype))
        res += [ref.relres(K, solve(b), b) for b in bs]
    limit = float(c.cfg["params"]["Solver"]["Iterative Solver"]
                  ["Convergence Tolerance"])
    return {"workload": workload, "dtype": dtype, "answers": len(res),
            "matrices": len(sets), "relres_max": max(res),
            "relres_median": float(np.median(res)), "relres_min": min(res),
            "limit": limit, "fails_limit": sum(r > limit for r in res)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)
    print(json.dumps(readings(ROOT, args.workload, args.dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
