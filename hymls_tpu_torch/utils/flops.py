"""Analytic flop/byte accounting for the multilevel preconditioner.

The reference threads flop counters through every class
(InitializeFlops / ComputeFlops / ApplyInverseFlops, e.g. reference
src/HYMLS_Preconditioner.cpp:612-680) and prints them with the timing
report.  Here the static plans make the counts exact closed forms, and
the byte counts feed roofline estimates on the TPU (HBM-bound apply,
MXU-bound factorization).
"""
from __future__ import annotations

from typing import Dict, List


def _level_counts(plan, dtype_bytes: int = 8) -> Dict[str, float]:
    n_sd, ni = plan.int_pos.shape
    ns = plan.sd_sep_pos.shape[1]
    n_blk, mb = plan.blk_pos.shape if plan.blk_pos.size else (0, 0)
    nnz_sc = plan.nnz_sc

    inv = lambda m: 2.0 * m ** 3        # LU + inverse accumulation
    mm = lambda a, b, c: 2.0 * a * b * c

    compute = n_sd * (inv(ni)                       # A11 inverse
                      + mm(ni, ni, ns)              # G = A11inv A12
                      + mm(ns, ni, ns)              # A21 G
                      + 2 * mm(ns, ns, ns) * 2)     # two Q (.) Q products
    compute += n_blk * inv(mb)
    compute += 2.0 * plan.sc11_gather.size          # contribution sums

    apply = n_sd * (mm(ni, ni, 1)                   # A11inv b1
                    + mm(ns, ni, 1)                 # A21 x1
                    + mm(ni, ns, 1))                # G x2
    apply += n_blk * mm(mb, mb, 1)
    apply += 8.0 * plan.w_vals.size                 # two OT applications
    apply += 2.0 * plan.sep_from_sd.size

    bytes_apply = dtype_bytes * (
        n_sd * (ni * ni + ns * ni + ni * ns)        # factor reads
        + n_blk * mb * mb
        + 6 * plan.n_nodes)                         # vector traffic
    return {"compute_flops": compute, "apply_flops": apply,
            "apply_bytes": bytes_apply}


def preconditioner_flops(precond) -> Dict[str, float]:
    """Closed-form flop counts for compute() and one apply_inverse()."""
    total = {"compute_flops": 0.0, "apply_flops": 0.0, "apply_bytes": 0.0}
    for plan in precond.plans:
        c = _level_counts(plan)
        for k in total:
            total[k] += c[k]
    if precond.coarse_plan is not None:
        n = precond.coarse_plan.n
        total["compute_flops"] += 2.0 * n ** 3
        total["apply_flops"] += 2.0 * n * n
        total["apply_bytes"] += 8.0 * n * n
    return total


def report(precond, timer=None) -> str:
    """Human-readable performance report (reference Tools::PrintTiming +
    flop counters)."""
    f = preconditioner_flops(precond)
    lines = ["Preconditioner cost model:"]
    lines.append(f"  compute (factorization): {f['compute_flops']/1e9:.3f} "
                 "GFLOP")
    lines.append(f"  apply (one V-cycle):     {f['apply_flops']/1e6:.3f} "
                 "MFLOP")
    lines.append(f"  apply HBM traffic:       {f['apply_bytes']/1e6:.3f} MB")
    for lev, plan in enumerate(precond.plans):
        n_sd, ni = plan.int_pos.shape
        ns = plan.sd_sep_pos.shape[1]
        lines.append(f"  level {lev}: {n_sd} subdomains, interior<= {ni}, "
                     f"separators<= {ns}, |SC|={plan.nnz_sc}, "
                     f"next n={plan.next_nodes.size}")
    if timer is not None:
        lines.append(timer.report())
    return "\n".join(lines)
