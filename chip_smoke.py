"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (hymls_tpu_torch
beside this file); it imports nothing of JAX.  Phases, each of which
raises on failure (nonzero exit, no result line):

  1. device: CUDA must be present; prints the card's name and power
     limit as nvidia-smi reports them;
  2. build: compiles every kernel of hymls_tpu_torch/csrc with nvcc,
     one process per source, all started together;
  3. kernels: each kernel against its plain torch version on the card,
     at the main path's shapes (cavity64: 19 bands x 12288) and on a
     ragged case (n = 577), in f32 and f64, with both times;
  4. main path: cavity64_Re1000 (synthetic Jacobian, bench.py's
     parameters, generic apply): IterativeRefinementSolver on cuda,
     compute() then newton_step(); true f64 relres <= 1e-11, inner f32
     iterations within 2 and f64 GMRES iterations within 1 of the CPU
     anchors in PERF.md; the DIA kernel must have been launched;
  5. times of compute() and newton_step().

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# CPU anchors of the slice on synthetic cavity64_Re1000, generic apply
# (PERF.md): inner f32 iterations of the IR Newton step, and the
# iterations of the plain f64 GMRES solve
ANCHOR_INNER = 75
ANCHOR_F64 = 72
RELRES_OK = 1e-11

TOL = {torch.float32: 1e-6, torch.float64: 1e-14}


def log(msg: str) -> None:
    print(msg, flush=True)


def cavity64():
    from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian
    K = cavity_jacobian(64, 64, re=1000.0).tocsr()
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    return K, b


def cavity64_params():
    """bench.py:_stokes_params(64, 2, 1, "Cartesian") with the generic
    apply."""
    from hymls_tpu_torch import Params
    return Params({
        "Problem": {"Equations": "Stokes-C", "Dimension": 2, "nx": 64,
                    "ny": 64},
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 250,
                                        "Convergence Tolerance": 1e-12}},
        "Preconditioner": {"Partitioner": "Cartesian",
                           "Separator Length": 4,
                           "Number of Levels": 1,
                           "Structured Apply": False},
    })


def gpu_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def event_ms(fn, reps: int = 60, inner: int = 20, warmup: int = 10):
    """Median over `reps` of CUDA-event time per call, each rep timing
    `inner` back-to-back calls on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def wall_median(fn, reps: int):
    """Median host seconds of `fn`, each call fenced by synchronize."""
    times = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def check_dia_kernel(device):
    """Phase 3: the DIA kernel against its plain version on the card."""
    from hymls_tpu_torch.ops.spmv import DiaOperator
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec, dia_matvec_reference

    K, _ = cavity64()
    rng = np.random.default_rng(11)
    rec = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        op = DiaOperator(K, dtype=dtype, device=device)
        cases = {"cavity64": (op.prepare(op.vals), op.offsets)}
        offs577 = (-25, -1, 0, 1, 25)
        cases["ragged577"] = (
            torch.as_tensor(rng.standard_normal((5, 577)), dtype=dtype,
                            device=device), offs577)
        rel_max = abs_max = 0.0
        for name, (bands, offs) in cases.items():
            x = torch.as_tensor(rng.standard_normal(bands.shape[1]),
                                dtype=dtype, device=device)
            y = dia_matvec(bands, x, offs)
            y_ref = dia_matvec_reference(bands, x, offs)
            torch.cuda.synchronize()
            err = float((y - y_ref).abs().max())
            rel = err / max(float(y_ref.abs().max()), 1e-300)
            log(f"dia_spmv {tag} {name}: k={len(offs)} n={bands.shape[1]} "
                f"max|y-y_ref|={err:.3e} rel={rel:.3e} (tol {TOL[dtype]:g})")
            if not (rel <= TOL[dtype]) or not torch.isfinite(y).all():
                raise RuntimeError(f"dia_spmv {tag} {name} disagrees with "
                                   f"its plain version: rel err {rel:.3e}")
            rel_max, abs_max = max(rel_max, rel), max(abs_max, err)
            if name == "cavity64":
                ms = event_ms(lambda: dia_matvec(bands, x, offs))
                plain_ms = event_ms(
                    lambda: dia_matvec_reference(bands, x, offs))
                log(f"dia_spmv {tag} cavity64 time: kernel {ms * 1e3:.2f} us,"
                    f" plain torch {plain_ms * 1e3:.2f} us per call")
        rec[tag] = {"max_abs_err": abs_max, "max_rel_err": rel_max,
                    "ms": ms, "plain_ms": plain_ms}
    return rec


def drive_main_path(device):
    """Phase 4: the IR Newton step on cavity64_Re1000; returns the
    solver, the result and the checks' numbers."""
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    from hymls_tpu_torch.stencils import create_testvector

    K, b = cavity64()
    params = cavity64_params()
    tv = create_testvector(params, K)
    t0 = time.perf_counter()
    S = IterativeRefinementSolver(K, params, testvector=tv, device=device)
    t_init = time.perf_counter() - t0
    S.compute()
    res = S.newton_step(S.op64.vals, S.solver.op.vals, b)
    x = res.x.cpu().numpy()
    relres = float(np.linalg.norm(K @ x - b) / np.linalg.norm(b))
    return K, b, S, res, relres, t_init


def coarse_inverse_residual(S):
    """max|I - A X| of the f32 coarse inverse, computed in f64."""
    from hymls_tpu_torch.core.preconditioner import (_compute_level,
                                                     _coarse_matrix)
    P = S.precond
    v = torch.as_tensor(P.K.data, dtype=torch.float32, device=P.device)
    for dp in P._dplans:
        _, v = _compute_level(v, dp)
    dc = P._dcoarse
    A = _coarse_matrix(v, dc["rows"], dc["cols"], dc["diag_entry"],
                       dc["fix_rows"], P.coarse_plan.n)
    X = P.factors["coarse"]["inv"]
    eye = torch.eye(A.shape[0], dtype=torch.float64, device=A.device)
    return tuple(A.shape), float((eye - A.double() @ X.double()).abs().max())


def main() -> int:
    t_start = time.perf_counter()
    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this script runs only on a GPU")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(gpu_name_and_power())
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} (count {count})")

    from hymls_tpu_torch.ops import _build
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32

    # -- 2. build -------------------------------------------------------------
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    for name in sources:
        _build.load(name)
    log(f"build: {sources} in {time.perf_counter() - t0:.2f} s")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions ----------------------------
    dia = check_dia_kernel(device)

    # -- 4. main path ---------------------------------------------------------
    dia_matvec.launches = 0
    t0 = time.perf_counter()
    K, b, S, res, relres, t_init = drive_main_path(device)
    torch.cuda.synchronize()
    launches = dia_matvec.launches
    log(f"main path: n={K.shape[0]} nnz={K.nnz} "
        f"bands={len(S.op64.offsets)} coarse n={S.precond.coarse_plan.n}; "
        f"setup {t_init:.2f} s, first compute+newton_step "
        f"{time.perf_counter() - t0 - t_init:.2f} s")
    log(f"newton_step: inner f32 iterations {res.iters} (anchor "
        f"{ANCHOR_INNER}), true f64 relres {relres:.3e}, converged "
        f"{res.converged}; dia_spmv launches {launches}")
    x = res.x
    if tuple(x.shape) != (K.shape[0],) or x.dtype != torch.float64 or \
            not bool(torch.isfinite(x).all()):
        raise RuntimeError("newton_step returned a malformed solution")
    if not relres <= RELRES_OK:
        raise RuntimeError(f"relres {relres:.3e} > {RELRES_OK:g}")
    if abs(res.iters - ANCHOR_INNER) > 2:
        raise RuntimeError(f"inner iterations {res.iters} not within 2 of "
                           f"the CPU anchor {ANCHOR_INNER}")
    if launches <= 0:
        raise RuntimeError("the main path never launched the dia_spmv "
                           "kernel")

    from hymls_tpu_torch import Solver
    S64 = Solver(K, S.precond, cavity64_params(), dtype=torch.float64,
                 device=device)
    x64, r64 = S64.apply_inverse(b)
    rel64 = float(np.linalg.norm(K @ x64.cpu().numpy() - b)
                  / np.linalg.norm(b))
    log(f"f64 GMRES: {r64.iters} iterations (anchor {ANCHOR_F64}), "
        f"true relres {rel64:.3e}")
    if abs(r64.iters - ANCHOR_F64) > 1 or not rel64 <= RELRES_OK:
        raise RuntimeError(f"f64 GMRES: {r64.iters} iterations, relres "
                           f"{rel64:.3e}")
    shape, cres = coarse_inverse_residual(S)
    log(f"coarse f32{list(shape)} inverse: max|I - A X| = {cres:.3e}")

    # -- 5. times -------------------------------------------------------------
    t_compute, _ = wall_median(S.compute, reps=5)
    t_newton, r = wall_median(
        lambda: S.newton_step(S.op64.vals, S.solver.op.vals, b), reps=5)
    per_iter = (t_newton - t_compute) / max(r.iters, 1)
    scalar = torch.ones((), device=device)
    reads = []
    for _ in range(50):
        t0 = time.perf_counter()
        float(scalar)
        reads.append(time.perf_counter() - t0)
    host_read = statistics.median(reads)
    log(f"times: compute {t_compute:.4f} s, newton_step {t_newton:.4f} s "
        f"({r.iters} inner iterations, {per_iter * 1e3:.3f} ms per inner "
        f"iteration incl. the f64 residuals), host scalar read "
        f"{host_read * 1e6:.1f} us (median of 5 / 50, wall clock)")

    f32, f64 = dia["f32"], dia["f64"]
    log(json.dumps({"kernels": [{
        "name": "dia_spmv", "route": "cuda",
        "source": "hymls_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "hymls_tpu/ops/pallas_spmv.py:50",
        "launches": launches,
        "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "max_rel_err_f32": f32["max_rel_err"],
        "max_rel_err_f64": f64["max_rel_err"],
        "max_abs_err_f64": f64["max_abs_err"], "ms_f64": f64["ms"],
        "plain_ms_f64": f64["plain_ms"]}]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
