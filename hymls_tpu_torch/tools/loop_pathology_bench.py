"""The loop-pathology probe on an NVIDIA GPU: a matvec chain run as one
device-side program against the same chain issued from the host.

    python -m hymls_tpu_torch.tools.loop_pathology_bench [--n 2048]

Counterpart of tools/loop_pathology_bench.py, which timed a chain of
dense matvecs inside one `lax.while_loop` program on the TPU.  Here the
device-side loop is one CUDA graph per iteration count, holding the
whole loop unrolled.  Each iteration runs one or two matvecs, then
x <- x / ||x||.  Variants:

  torch1     : one torch.matmul per iteration, captured
  torch2     : two chained torch.matmuls per iteration, captured
  kernel1    : one dense_matvec (the hand-written CUDA kernel K2)
               per iteration, captured (the reference's pallas1)
  kernel2    : two chained dense_matvecs, captured (pallas2)
  redispatch : the two-matmul body issued from the host every
               iteration, one synchronize at the end

Operands are the reference's: M1, M2 f32[n, n] and x f32[n, 1] from
np.random.default_rng(0), the matrices scaled by 1/sqrt(n).  A captured
variant is timed as (t(10 + 100) - t(10)) / 100 with CUDA events around
the graph replays, which cancels the launch of the graph itself.

The floor is measured on the card, not assumed: the device-to-device
copy bandwidth (read plus write) on a 32 MB tensor, and on a 256 MB one
that does not fit in the 50 MB L2; the two-matvec body reads 2 n^2 * 4
bytes per iteration.  A failing variant raises: nothing is skipped.
Each kernel variant's final iterate is held against that of its
torch.matmul twin, which starts from the same operands (ITERATE_TOL).
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..ops.dense_matvec import dense_matvec

N = 2048        # matrix dim; 2 matrices x 16 MB = 32 MB working set
ITERS = 100
WARM_ITERS = 10
VARIANTS = ("torch1", "torch2", "kernel1", "kernel2", "redispatch")

BODIES = {
    "torch1": lambda M1, M2, v: torch.matmul(M1, v),
    "torch2": lambda M1, M2, v: torch.matmul(M2, torch.matmul(M1, v)),
    "kernel1": lambda M1, M2, v: dense_matvec(M1, v),
    "kernel2": lambda M1, M2, v: dense_matvec(M2, dense_matvec(M1, v)),
}
# the host-issued loop runs the two-matmul body (reference :112-121)
BODIES["redispatch"] = BODIES["torch2"]
# each kernel variant's final iterate (after 10 + ITERS iterations from
# the same x) must lie within ITERATE_TOL, in the 2-norm, of its torch
# twin's.  f32 summation-order drift over 110 iterations is 2e-6 at
# n = 2048 and 4e-6 at n = 4096; scaling one row of the body by
# 1 + 1e-3 already moves the iterate by about 1e-4.
TWINS = {"kernel1": "torch1", "kernel2": "torch2"}
ITERATE_TOL = 1e-4


def make_operands(n: int = N, *, device):
    """(M1, M2, x): the reference's operands, in f32 on `device`."""
    rng = np.random.default_rng(0)
    M1 = rng.standard_normal((n, n)) / np.sqrt(n)
    M2 = rng.standard_normal((n, n)) / np.sqrt(n)
    x = rng.standard_normal((n, 1))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (M1, M2, x))


def step(name: str, M1, M2, x):
    """One iteration of variant `name`: its body, then x / ||x||."""
    y = BODIES[name](M1, M2, x)
    return y / torch.linalg.norm(y)


def _capture(name, M1, M2, x0, niter):
    """A CUDA graph of `niter` unrolled iterations of variant `name`;
    returns (graph, its output tensor)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up (cuBLAS workspace)
        step(name, M1, M2, x0)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        v = x0
        for _ in range(niter):
            v = step(name, M1, M2, v)
    return g, v


def _replay_ms(g, reps: int = 7) -> float:
    """Median CUDA-event time of one replay of graph `g`, in ms."""
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_captured(name, M1, M2, x):
    """(t(10 + ITERS) - t(10)) / ITERS in ms per iteration, and the
    output of the longer graph."""
    t = {}
    out = None
    for niter in (WARM_ITERS, WARM_ITERS + ITERS):
        g, out = _capture(name, M1, M2, x, niter)
        t[niter] = _replay_ms(g)
    return (t[WARM_ITERS + ITERS] - t[WARM_ITERS]) / ITERS, out


def time_redispatch(M1, M2, x):
    """Host-clock ms per iteration of ITERS host-issued iterations
    followed by one synchronize, and the last iterate."""
    v = step("redispatch", M1, M2, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v = x
    for _ in range(ITERS):
        v = step("redispatch", M1, M2, v)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ITERS * 1e3, v


def copy_bandwidth(nbytes: int, *, device, reps: int = 20) -> float:
    """Device-to-device copy bandwidth in bytes/s (bytes read plus
    bytes written), median of `reps` CUDA-event timed copies."""
    src = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return 2 * nbytes / (statistics.median(times) * 1e-3)


def floors(n: int = N, *, device):
    """The measured copy bandwidths and the bandwidth floors (ms per
    iteration) of the two-matvec body: at `n`, from the 32 MB copy, and
    at n = 8192 (a 512 MB working set, beyond L2), from the 256 MB
    copy."""
    bw32 = copy_bandwidth(32 << 20, device=device)
    bw256 = copy_bandwidth(256 << 20, device=device)
    return {"bw_32MB": bw32, "bw_256MB": bw256,
            "n": n, "floor_ms": 2 * n * n * 4 / bw32 * 1e3,
            "floor_8192_ms": 2 * 8192 * 8192 * 4 / bw256 * 1e3}


def iterate_gaps(outs):
    """||v_kernel - v_torch||_2 of the final iterates of each kernel
    variant and its torch.matmul twin, for the pairs present in
    `outs`."""
    return {k: float(torch.linalg.norm(outs[k] - outs[t]))
            for k, t in TWINS.items() if k in outs and t in outs}


def run_probe(n: int = N, variants=VARIANTS, *, device):
    """ms per iteration of each variant at size `n`, and its final
    iterate; raises if any variant fails, returns a vector that is not
    finite and of unit norm, or ends more than ITERATE_TOL from its
    torch.matmul twin's final iterate."""
    M1, M2, x = make_operands(n, device=device)
    res, outs = {}, {}
    for name in variants:
        if name == "redispatch":
            res[name], outs[name] = time_redispatch(M1, M2, x)
        else:
            res[name], outs[name] = time_captured(name, M1, M2, x)
        v = outs[name]
        norm = float(torch.linalg.norm(v))
        if tuple(v.shape) != (n, 1) or not bool(torch.isfinite(v).all()) \
                or abs(norm - 1.0) > 1e-4:
            raise RuntimeError(f"probe variant {name}: malformed result "
                               f"(shape {tuple(v.shape)}, norm {norm})")
    for name, gap in iterate_gaps(outs).items():
        if not gap <= ITERATE_TOL:
            raise RuntimeError(f"probe variant {name}: final iterate is "
                               f"{gap:.3e} from {TWINS[name]}'s "
                               f"(tolerance {ITERATE_TOL:g})")
    return res, outs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="matrix dimension")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("loop_pathology_bench: no CUDA device; the probe "
                         "measures the GPU only")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    fl = floors(args.n, device=device)
    res, _ = run_probe(args.n, device=device)
    print(f"device {torch.cuda.get_device_name(0)}")
    print(f"copy bandwidth: {fl['bw_32MB'] / 1e9:.1f} GB/s on 32 MB, "
          f"{fl['bw_256MB'] / 1e9:.1f} GB/s on 256 MB")
    print(f"(bandwidth-bound floor for the 2-matvec body: "
          f"{fl['floor_ms']:.4f} ms at n = {args.n}; "
          f"{fl['floor_8192_ms']:.4f} ms at n = 8192, beyond L2)")
    for k, v in res.items():
        print(f"{k:12s} {v:.4f} ms/iter")
    return res


if __name__ == "__main__":
    main()
