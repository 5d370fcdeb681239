"""The DIA SpMV kernel's sweeps: shapes, bounds, graph-replay timing, and
a side-by-side timing of several builds of a `dia_spmv.cu`.

    python -m hymls_tpu_torch.tools.dia_spmv_sweep [--part spmv|spmm]
        NAME=SRC[:FLAG,...] ...

builds each SRC (a `dia_spmv.cu` with the package's C interface) with
the package's nvcc flags plus FLAGs (for example
`-DHYMLS_SPMM_VB_CAP=2` or `-DHYMLS_SPMM_MAX_THREADS=128`, the
multi-column launcher's vector-group cap and largest block), checks each
against the plain version and prints the device time per launch of
every build, replayed in turns from CUDA graphs, beside the bound and an
empty launch: for the single-vector entry at every shape of SWEEP, for
the multi-column entry at every shape and block size of MATMAT_SWEEP
(with the package's plan for it), in f32 and f64.  Without --part it
runs both.  Needs a CUDA card; chip_smoke.py uses the helpers for its
phase 3.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build

#: the sweep: the main path's shape (cavity64), then larger grids up to
#: beyond the 50 MB L2, each from the port's own generators
SWEEP = ("cavity64", "stokes128", "cavity128", "stokes3d32", "cavity512",
         "cavity1024")
#: published H100 SXM peaks (data sheet, 700 W): HBM bandwidth, and the
#: f32 and f64 rates outside the tensor cores
#: the multi-column sweep: the deflation setups' operators of
#: chip_smoke.py phases 18 and 19 at their block sizes (k = 8 and 6, and
#: kp = k + 6), a 5-band shape beyond the 50 MB L2 and the 19-band 3-D
#: Stokes operator (register pressure), each at two block sizes
MATMAT_SWEEP = (("aniso128", (8, 14)), ("neumann128", (6, 12)),
                ("aniso1024", (8, 14)), ("stokes3d16", (8, 14)))
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
GRAPH_LAUNCHES = 100
TOL = {torch.float32: 1e-6, torch.float64: 1e-14}


def sweep_matrix(name: str):
    """The CSR matrix of a sweep shape, canonical (sorted, summed)."""
    from ..stencils import stokes2d, stokes3d
    from ..stencils.navier_stokes import cavity_jacobian
    if name.startswith("cavity"):
        m = int(name[6:])
        K = cavity_jacobian(m, m, re=1000.0)
    elif name == "stokes3d32":
        K = stokes3d(32, 32, 32)
    else:
        m = int(name[6:])
        K = stokes2d(m, m)
    K = K.tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return K


def matmat_matrix(name: str):
    """The CSR matrix of a multi-column sweep shape: the anisotropic
    Laplace (eps = 0.01) of chip_smoke.py phase 18, the Neumann Laplace
    of phase 19, or the 3-D Stokes operator at m^3."""
    from ..stencils import laplace2d_neumann, stokes3d
    from ..stencils.generators import _cross2d
    if name.startswith("aniso"):
        m, eps = int(name[5:]), 0.01
        K = -_cross2d(m, m, 2 + 2 * eps, -1.0, -1.0, -eps, -eps)
    elif name.startswith("neumann"):
        m = int(name[7:])
        K = laplace2d_neumann(m, m)
    else:
        m = int(name[8:])
        K = stokes3d(m, m, m)
    return K.tocsr()


def bound(n: int, k: int, dtype) -> tuple:
    """(least ms, what bounds it) for one DIA matvec: each band, x and
    y moved once at the HBM rate, against 2k flops per row at the
    type's peak."""
    size = torch.finfo(dtype).bits // 8
    t_bytes = (k + 2) * n * size / HBM_BYTES_PER_S
    t_ops = 2 * k * n / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_mm(n: int, k: int, nvec: int, dtype) -> tuple:
    """(least ms, what bounds it) for one multi-column DIA product of
    nvec vectors: the bands once, X and Y once each at the HBM rate,
    against 2 k n nvec flops at the type's peak."""
    size = torch.finfo(dtype).bits // 8
    t_bytes = (k * n + 2 * nvec * n) * size / HBM_BYTES_PER_S
    t_ops = 2 * k * n * nvec / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def capture(fn, launches: int = GRAPH_LAUNCHES):
    """A CUDA graph of `launches` back-to-back calls of `fn`, warmed up
    on a side stream as capture requires."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def replay_us(graphs, reps: int = 15, launches: int = GRAPH_LAUNCHES):
    """Median device us per launch of each captured graph, by CUDA
    events around one replay, the graphs replayed in turns (forward,
    then backward) so that drift falls on all alike."""
    names = list(graphs)
    times = {k: [] for k in names}
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[k].replay()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) * 1e3 / launches)
    return {k: statistics.median(v) for k, v in times.items()}


def start_build(src: str, so: str, flags=()):
    """Start nvcc on another `dia_spmv.cu` with the package's flags."""
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS,
                             *flags, "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


_SPMV_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p]
_SPMM_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def load_build(proc, so: str):
    """{"spmv": {dtype: C entry}, "spmm": {dtype: C entry}} of a build
    started by `start_build`; "spmm" is empty for a source without the
    multi-column entry."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"dia_spmv build {so} failed:\n{out}")
    report = _build.parse_ptxas(out)
    spills = sorted(f for f, r in report.items() if r[1] or r[2])
    most = max(((r[0], f) for f, r in report.items()), default=None)
    print(f"build {os.path.basename(so)}: {len(report)} kernel instances, "
          f"most registers {most}, spilling {spills or 'none'}", flush=True)
    lib = ctypes.CDLL(so)
    fns = {"spmv": {}, "spmm": {}}
    for part, args in (("spmv", _SPMV_ARGS), ("spmm", _SPMM_ARGS)):
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            fn = getattr(lib, f"hymls_dia_{part}_{tag}", None)
            if fn is not None:
                fn.argtypes = args
                fn.restype = ctypes.c_int
                fns[part][dtype] = fn
    return fns


def caller(fn, bands, x, offs):
    """A call of another build's entry point, as the wrapper makes it."""
    n = x.shape[0]

    def call():
        y = torch.empty_like(x)
        err = fn(bands.data_ptr(), n, x.data_ptr(), y.data_ptr(), n,
                 offs.ptr, offs.k, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dia_spmv launch failed: CUDA error {err}")
        return y
    return call


def caller_mm(fn, bands, X, offs):
    """A call of another build's multi-column entry point, as the
    wrapper makes it."""
    nvec, n = X.shape

    def call():
        Y = torch.empty_like(X)
        err = fn(bands.data_ptr(), n, X.data_ptr(), Y.data_ptr(), n, nvec,
                 offs.ptr, offs.k, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dia_spmm launch failed: CUDA error {err}")
        return Y
    return call


def _sweep_spmv(builds, device) -> None:
    from ..ops.dia_spmv import dia_matvec_packed, dia_matvec_reference
    from ..ops.spmv import DiaOperator

    rng = np.random.default_rng(11)
    for shape in SWEEP:
        K = sweep_matrix(shape)
        op = DiaOperator(K, dtype=torch.float64, device=device)
        b64, offs = op.prepare(op.vals), op.packed
        n = K.shape[0]
        xs = rng.standard_normal(n)
        for dtype in (torch.float32, torch.float64):
            bands = b64.to(dtype)
            x = torch.as_tensor(xs, dtype=dtype, device=device)
            y_ref = dia_matvec_reference(bands, x, offs.offsets)
            scale = float(y_ref.abs().max())
            calls = {"package": lambda: dia_matvec_packed(bands, x, offs)}
            calls.update({name: caller(fns["spmv"][dtype], bands, x, offs)
                          for name, fns in builds.items()})
            for name, call in calls.items():
                rel = float((call() - y_ref).abs().max()) / scale
                if not rel <= TOL[dtype]:
                    raise RuntimeError(f"{name} {shape} {dtype}: rel err "
                                       f"{rel:.3e}")
            one = torch.zeros(1, device=device)
            graphs = {name: capture(call) for name, call in calls.items()}
            graphs["empty launch"] = capture(lambda: one.zero_())
            dev = replay_us(graphs, reps=21)
            b_us = bound(n, offs.k, dtype)[0] * 1e3
            print(f"{shape} {str(dtype)[6:]} bound {b_us:.3f} us: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in dev.items()),
                  flush=True)
        del op, b64
        torch.cuda.empty_cache()


def _sweep_spmm(builds, device) -> None:
    from ..ops.dia_spmv import (dia_matmat_packed, dia_matmat_reference,
                                matmat_plan)
    from ..ops.spmv import DiaOperator

    rng = np.random.default_rng(17)
    for shape, blocks in MATMAT_SWEEP:
        K = matmat_matrix(shape)
        op = DiaOperator(K, dtype=torch.float64, device=device)
        b64, offs = op.prepare(op.vals), op.packed
        n = K.shape[0]
        for dtype in (torch.float32, torch.float64):
            bands = b64.to(dtype)
            for nb in blocks:
                X = torch.as_tensor(rng.standard_normal((nb, n)),
                                    dtype=dtype, device=device)
                Y_ref = dia_matmat_reference(bands, X, offs.offsets)
                calls = {"package": lambda: dia_matmat_packed(bands, X,
                                                              offs)}
                calls.update({name: caller_mm(fns["spmm"][dtype], bands,
                                              X, offs)
                              for name, fns in builds.items()
                              if dtype in fns["spmm"]})
                scale = dia_matmat_reference(
                    bands.abs(), X.abs(),
                    offs.offsets).clamp_min(torch.finfo(dtype).tiny)
                for name, call in calls.items():
                    err = float(((call() - Y_ref).abs() / scale).max())
                    if not err <= 4 * torch.finfo(dtype).eps:
                        raise RuntimeError(f"{name} {shape} B={nb} {dtype}: "
                                           f"{err:.3e} of sum|terms|")
                one = torch.zeros(1, device=device)
                graphs = {name: capture(call) for name, call in calls.items()}
                graphs["empty launch"] = capture(lambda: one.zero_())
                dev = replay_us(graphs, reps=21)
                b_us = bound_mm(n, offs.k, nb, dtype)[0] * 1e3
                plan = matmat_plan(n, nb, offs.k, dtype)
                print(f"{shape} B={nb} {str(dtype)[6:]} plan {plan} bound "
                      f"{b_us:.3f} us: " + ", ".join(
                          f"{k} {v:.3f}" for k, v in dev.items()),
                      flush=True)
                del X, Y_ref, scale, graphs
        del op, b64
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("spmv", "spmm"),
                    help="only the single-vector or the multi-column entry")
    ap.add_argument("builds", nargs="*", metavar="NAME=SRC[:FLAG,...]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dia_spmv_sweep: needs a CUDA card")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    builds = {}
    for arg in args.builds:
        name, spec = arg.split("=", 1)
        src, _, flags = spec.partition(":")
        so = os.path.join(_build.BUILD_DIR, f"libdia_spmv_{name}.so")
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        builds[name] = (start_build(src, so, [f for f in flags.split(",")
                                              if f]), so)
    builds = {name: load_build(*b) for name, b in builds.items()}
    if args.part != "spmm":
        _sweep_spmv(builds, device)
    if args.part != "spmv":
        _sweep_spmm(builds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
