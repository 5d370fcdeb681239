#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the port (hymls_tpu_torch), on
a machine with as many CUDA cards as the cell asks for.  The last line of
standard output is the result object; the numbers the check compared,
with their limits, are the last lines of standard error.  Exits non-zero,
with no result, without the cards, without the program, or when a
module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this folder heads sys.path; its modules are imported as
# portbench.* from the root instead, and never shadow a module of the
# standard library (trace)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with few threads: the calls are issued by one host
    # thread, and no library's pool of threads competes with it
    for v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[v] = "1"
    # every cache of the program at a fixed place inside the checkout:
    # the plan disk cache here, the kernels in hymls_tpu_torch/_build
    cache = os.path.join(ROOT, "portbench", ".plan_cache")
    os.makedirs(cache, mode=0o700, exist_ok=True)
    os.environ["HYMLS_PLAN_CACHE"] = cache

    import torch
    from portbench import harness

    chips = int(harness.load_cell(ROOT, args.workload).cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    print("portbench: card " + card_line(), file=sys.stderr, flush=True)
    out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    bad = harness.banned_modules()
    if bad:
        print(f"portbench: modules loaded that may not be: {bad}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, v in out["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    import subprocess
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().replace("\n", "; ") or p.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


if __name__ == "__main__":
    sys.exit(main())
