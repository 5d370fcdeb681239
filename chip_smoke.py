"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py [--baseline DIR]

Needs one CUDA card, nvcc and the repository checkout (hymls_tpu_torch
beside this file); it imports nothing of JAX.  Phases, each of which
raises on failure (nonzero exit, no result line):

  1. device: CUDA must be present; prints the card's name and power
     limit as nvidia-smi reports them;
  2. build: compiles every kernel of hymls_tpu_torch/csrc (dia_spmv.cu
     with K1 and its multi-column form, dense_matvec.cu) with nvcc, one
     process per source, all started together (and, with --baseline
     DIR, DIR's dia_spmv.cu beside them), and prints ptxas's registers
     and spills per kernel instance;
  3. kernels: each kernel against its plain torch version on the card.
     The DIA SpMV at six shapes from the port's generators -- cavity64
     (the main path's, 19 bands x 12288), stokes128, cavity128,
     stokes3d32, cavity512 and cavity1024 (beyond the 50 MB L2) -- in
     f32 and f64 (relative tolerance 1e-6 / 1e-14), also with an x not
     16-byte aligned and with an x of stride 2 (the real part of a
     complex tensor: the wrapper must refuse it and take its contiguous
     copy).  Per shape and
     type: device time per launch by CUDA-graph replay of 100 launches,
     beside the bound (bytes at 3.35 TB/s), an empty launch, cuSPARSE's
     CSR SpMV on the same matrix (torch.mv on a sparse CSR tensor, timed
     here only) and, with --baseline, DIR's kernel; the call with host
     issue (CUDA events) and the host issue alone (wall clock, no
     synchronize), for the kernel and for cuSPARSE.  Then, without
     timing, the DIA operators of phases 18, 19 and 21 as make_operator
     builds them (5 bands: the anisotropic and the Neumann Laplace at
     128^2, Laplace 64^2, and their transposes) and those of every
     refinement of phase 22's and phase 27's configs as the driver
     builds them, with their transposes, in f64 and f32, with an
     aligned and an unaligned x, at the same tolerances.  K1's
     multi-column form (dia_matmat, the deflation setups' batched DIA
     products) on all those operators at every block size of
     MATMAT_COVER_BLOCKS and MATMAT_BLOCKS and on random operators of
     4 to 48 bands, in f64 and f32 (per element within 4 ulp of
     sum_k |bands x|), each row equal to K1's on that row bit for bit,
     every kernel instance its launcher can pick run at least once; at
     phases 18's and 19's operators and block sizes, a 5-band shape
     beyond L2 (aniso1024) and the 19-band 3-D Stokes operator at 16^3,
     its device time by CUDA-graph replay beside its bound, an empty
     launch, B launches of K1, the plain version, cuSPARSE's SpMM
     (torch.sparse.mm) and, with --baseline, DIR's multi-column entry,
     and the us each added vector costs.  The dense
     matvec
     at the probe's n = 2048 and 8192 and the ragged n = 2047 and 300
     (relative tolerance 1e-5, f32), with graph-replay device times
     against torch.matmul at 2048 and 8192.  The sentinel gather K3 on
     level 0's generic apply plans of the benchmark's 3-D and THCM
     configurations at their size (plans built on the card, no
     factorization): every index field equal to the plain version bit
     for bit, in f32 and f64 and on a (4, L) block under vmap; at
     `int_pos` and `node_src` in f32 the device time per launch by
     CUDA-graph replay of 100 launches beside its bound (8 B of index
     and 4 + 4 B of data an output at 3.35 TB/s), an empty launch and
     the plain version; then the generic block apply on the card (the
     3-D configuration at 16^3 in f64, B = 3, under torch.func.vmap)
     against its columns, every gather of it on the kernel;
  4. probe path: the loop-pathology probe
     (hymls_tpu_torch.tools.loop_pathology_bench) at n = 2048, every
     variant, and its two-matvec variants at n = 8192 (beyond L2), with
     the measured copy-bandwidth floors; each kernel variant's final
     iterate must agree with its torch.matmul twin's, and the dense
     matvec kernel must have been launched.  Its launch count is the
     wrapper's calls while the CUDA graphs were captured and warmed up;
     each graph replay runs those launches again on the device without
     counting them;
  5. main path: cavity64_Re1000 (synthetic Jacobian, bench.py's
     parameters, 'Structured Apply' "Auto"): the structured program
     must be active; IterativeRefinementSolver on cuda, compute() then
     newton_step(); true f64 relres <= 1e-11, inner f32 iterations
     within 2 and f64 GMRES iterations within 1 of the CPU anchors in
     PERF.md; the DIA kernel must have been launched;
  6. generic path: the same with 'Structured Apply' False, the same
     anchors;
  7. times of compute() (and the structured repack) and newton_step()
     for both applies, interleaved inside this one call; kernel
     launches per step and per apply (torch.profiler), host issue and
     device time per V-cycle apply;
  8. warm Newton sequence on cavity64_Re1000, structured ("Auto") and
     generic apply: compute() and a cold newton_step, then 4
     newton_step_warm calls threading the factors through bench.py's
     warm sequence (values times 1 + 1e-6 (i + 1)); each step's true
     f64 relres <= 1e-11 and inner f32 iterations within 2 of the JAX
     package's CPU count; then, interleaved as in phase 7, compute()
     against recompute(), newton_step against newton_step_warm, the
     host syncs (scalar reads, error checks) per compute and recompute
     and the device busy time of each (torch.profiler);
  9. bordered f64 GMRES on cavity64_Re1000 with the constant-pressure
     border ('Fix Pressure Level' off): the structured program must be
     inactive, true relres <= 1e-11, iterations within 1 of the JAX
     package's CPU count, |border coefficients| <= 1e-8;
 10. Bratu 64^2 (tests/test_nonlinear.py's problem): NewtonSolver to
     lam = 0.5, then Continuation.trace through the fold; the reference
     test's criteria, max and last lam within 1e-6 of the JAX package's
     CPU trace; time and DIA launches per corrector;
 11. stokesB_64, bench.py's case at its own size (configs/stokes_B.xml
     at 64^2 with bench.py's 250 iterations and 1e-12, b from
     default_rng(3)): Stokes on the B-grid, L = 2, 'Apply Dropping'
     false, so "Auto" must leave the structured program off (with the
     reason) and run the generic apply; compute() then newton_step();
     true f64 relres <= 1e-11, inner f32 iterations within 2 of the JAX
     package's CPU count;
 12. stokes128_L2 (bench.py: Stokes-C 128^2, n = 49152, Cartesian,
     L = 2, default_rng(1)) on the default apply: the same relres, and
     inner iterations within 10% of the CPU count (the card's f32
     factors round otherwise: 109 against 115);
 13. restarted f64 GMRES on cavity64_Re1000 with 'Num Blocks' 30:
     converged, true relres <= 1e-11, iterations within 1 of the JAX
     package's CPU count for that restart; then
     IterativeRefinementSolver with 'Num Blocks' 60 (below its inner
     basis of 64) constructs and steps with phase 5's anchors;
 14. direct Schur ('Number of Levels' 0) on cavity64 in f64.  Plain: K
     is singular and the pressure of cell 0 is pinned in the Schur
     complement, so one apply_inverse leaves ~1e-6 and GMRES needs 2
     iterations (the JAX package's CPU count) to relres <= 1e-10.  With
     phase 9's constant-pressure border (the pin off): one
     apply_inverse_bordered is the exact solve, relres <= 1e-10 without
     Krylov, and GMRES needs 1 iteration.  Prints n_sep and the seconds
     of the dense factorization;
 15. B-grid transform: configs/stokes_L2.xml at its own 8^3 (with
     dropping the reference does not converge in 200 iterations at
     16^3 either), with and without the transform: the config's target
     (<= 80 iterations, relres < 1e-9), iterations within 1 of the JAX
     package's CPU counts, and 2 DIA launches more per preconditioner
     apply with the transform than without; then its no-dropping
     variant (tests/test_bgrid.py) at 16^3 on the generic apply, 2
     iterations;
 16. 'Factor Precision' 'f64' on cavity64's Newton step, 'Schur
     Assembly' 'Full f64' and 'Vsum f64': phase 5's anchors, and
     compute() seconds of both beside the 'Same' chain's, interleaved;
 17. stokes32cube_skew_L2 (bench.py: Stokes-C 32^3, n = 131072, skew,
     L = 2, 'Num Blocks' 60, tolerance 1e-8, default_rng(2)): plan
     build seconds, newton_step with bench.py's checks (relres <= 1e-7,
     at most 500 inner iterations) and within 15% of the JAX package's
     CPU count (the two packages' f32 factors differ by 6% there on the
     CPU), then the restarted f64 GMRES solve that 'Num Blocks' asks
     for, held the same way;
 18. deflated solve: tests/test_variants.py's anisotropic Laplace at
     128^2 (n = 16384), L = 2, GMRES to 1e-10, 8 deflated modes:
     setup_deflation() (the subspace iteration, one block apply of
     kp = 14 columns per iteration, then the 8 projected solves as one
     batched GMRES) and one solve; true relres <= 5e-9, iterations
     within 2 of the JAX package's CPU count and no more than without
     deflation, the subspace iteration converged (rel <= 1e-5) before
     its cap, V'V = I to 1e-10; the setup's split, block applies and
     launches of K1 and dia_matmat are printed, and the setup must have
     launched dia_matmat, the solve K1;
 19. bordered + deflated: tests/test_combos.py's Neumann Laplace with
     the constant null space as border at 128^2, L = 2, 6 modes of the
     augmented system; relres and error <= 5e-9, iterations as in 18;
 20. complex solves in complex128: (A + 0.5 i I) z = b on the Laplace
     operator at 128^2, L = 1 (error <= 1e-8, iterations within 1 of
     the JAX package's CPU count), timed beside the real f64 solve of
     the same A; the complex bordered solve of tests/test_combos.py at
     128^2 (relres <= 1e-8, iterations within 1);
 21. eigenvalues: (a) JDQR on configs/laplace1_eigs.xml's problem at
     its refined 64^2: 10 converged in <= 70 outer iterations (within 5
     of the JAX package's CPU count), values within 1e-8 of a host
     shift-invert ARPACK run, residuals <= 1e-7; (b) JDQR on the cavity
     Jacobian at Re 1000, at 16^2 and at 64^2: 4 values, among them a
     conjugate pair, so the complex correction solver runs; values
     within 1e-6 (64^2: 1e-5) of the largest |lambda| from those the
     JAX package locks on the CPU, residuals <= 1e-5; (c)
     shift_invert_eigs around the port's Solver on Laplace 64^2: 10
     values within 1e-8 of ARPACK's, inner solves within 2 of the JAX
     package's CPU count; the DIA kernel must have run.

 22. the driver on the card: run_with_refinements (the entry point of
     `python -m hymls_tpu_torch.driver`) on configs/laplace1.xml,
     stokes2.xml, bordering1.xml, deflation1.xml, laplace1_eigs.xml and
     stokes2_3D.xml at their own sizes and refinement depths (stokes2_3D
     builds its matrix: its dataset is not in the repository), all in
     f64: every config's 'Targets' met, every solve's iterations within
     1 of the JAX package's CPU count and JDQR's outer iterations within
     5; then one subprocess `python -m hymls_tpu_torch.driver
     configs/laplace1.xml`, which must exit 0 with "ALL TESTS PASSED";
 23. the MATLAB bridge: `python -m hymls_tpu_torch.matlab_bridge DIR` in
     a subprocess on the card, driven through its file protocol on the
     cavity64 Jacobian (init, apply of two columns, compute with new
     values, apply, free); each apply within 1e-12 (relative) of an
     in-process preconditioner on the card built from the same files;
 24. the plan disk cache: phase 17 runs with HYMLS_PLAN_CACHE a fresh
     temporary directory, so its cold build stores the 32^3 plans;
     here stokes32cube_skew_L2 is constructed again and must load them
     and build none; the host plan seconds of both, and the Newton step
     after the load held as phase 17 holds it (and beside phase 17's
     count);
 25. distributed (hymls_tpu_torch.parallel): 4 ranks spawned by
     parallel/launch.run, all on cuda:0, exchanging over gloo through
     host memory (one H100 takes one NCCL rank), each solve's
     distributed path asserted active on every rank
     (hymls_tpu_torch/tools/dist_cases.py holds the rank body):
     (a) the cavity64_Re1000 IR newton_step with 'Distributed Apply'
     and 'Structured Apply' False: true f64 relres <= 1e-11, inner f32
     iterations within 2 of the replicated step run in the same phase
     on the card and of the JAX package's CPU count at 4 devices;
     (b) stokes128_L2 the same, held to 10% of the JAX CPU count as
     phase 12; (c) f64 solves -- GMRES on cavity64, phase 9's bordered
     solve, phase 18's deflated solve, phase 20's complex solve --
     within 1 iteration of the replicated solves on the card; (d) the
     halo V-cycle against the replicated generic apply and the
     distributed factors against the replicated ones on cavity64 and
     stokes128_L2 in f64 (1e-12 relative; whether exactly equal is
     printed), with one apply's collective calls and bytes; (e) the
     halo DIA matvec against K @ x at cavity64 (f64, f32) and stokes128
     (f64), the DIA kernel launched on every rank.  Then a world-size-1
     NCCL group on cuda:0 runs ppermute (to itself: a local copy),
     psum and all_gather on device tensors; multi-rank NCCL needs two
     or more cards and is not run.  The distributed step's seconds
     beside the replicated one's are printed and labelled: 4 ranks
     sharing one card over host staging is not a scaling number;
 26. the sharded structured apply, on the same 4 ranks in the same
     spawn as phase 25 (core/structured.py ShardedApply;
     hymls_tpu_torch/tools/dist_cases.py phase26): (a) the
     cavity64_Re1000 IR newton_step with 'Distributed Apply' and
     'Structured Apply' "Auto" (bench.py's parameters), which must
     take the sharded structured apply on every rank (not the halo
     V-cycle): every rank the same inner f32 iterations, within 2 of
     the replicated structured step run in the same phase on the card
     and of the JAX package's CPU count at 4 devices, true f64 relres
     <= 1e-11, the DIA kernel launched on every rank; (b) stokes128_L2
     the same, held to 10% of the JAX CPU count as phase 12; (c) on
     cavity64 and stokes128_L2 in f64, one sharded apply against the
     replicated structured apply (1e-12 relative; whether exactly
     equal is printed), its ppermute and all_gather calls and bytes
     equal to those the design states (ShardedApply.traffic).  The
     sharded and replicated step times are printed beside phase 25's
     halo step, with the same label;
 27. the config suite: run_with_refinements on the card, as in phase
     22, on every config of driver_cases.SUITE_CONFIGS (the rest of the
     reference's suite that builds its own matrix: stokes4, stokes4_3D,
     stokes5, stokes_L, stokes_THCM, deflation1_bordering,
     laplace1_eigs_deflation, laplace_eigs, neumann, stokes6, stokes_L3,
     stokes_L4, stokes_THCM3, stokes_THCM4, laplace2_eigs, darcy,
     convdiff) at its own size, depth, factorizations and solves, in
     f64: every 'Targets' met, every solve's iterations within 1 of the
     JAX package's CPU count (ANCHOR_SUITE), JDQR's outer iterations
     within 5, every solver on a DIA operator and the DIA kernel
     launched; per config the apply "Auto" took, compute and solve s
     per refinement and the kernels' launches are printed, and per
     deflation setup (here and in phase 22) its split as in phase 18;
     each must have launched dia_matmat.  Then the
     3-D two-level configs on the structured apply (SUITE_GENERIC) once
     more with 'Structured Apply' False, under the same gates, their
     solve s beside the structured run's;
 28. the V-cycle apply replayed from its CUDA graph
     (core/apply_graph.py) against the eager apply, bit for bit:
     cavity128 on one level (a coarse inverse), a B = 8 block, stokes2
     128^2 on three levels, upstream's stokes2_3D at 32^3 on the generic
     gather apply (the benchmark's stokes3d_32_L2, a 3528-unknown
     coarse; its plans built cold into a fresh plan cache, then loaded,
     each under the profiler: the `hymls.plan*` spans' seconds and the
     plan counters), the 8^3 B-grid configuration (K1 inside the
     graph), capture on K_1 then compute(K_2), four recaptures of a
     Newton sequence (the memory reserved must not grow), a capture
     under torch.profiler and one that raises (eager, with a warning;
     the next capture works); host issue and CUDA-event time per apply
     of both.  Every apply_fn on the card before it replays too; phase
     15 counts K1 launches per apply on the eager apply;
 29. the large coarse system held as its explicit inverse on the card
     (dense_factor's branch off the CPU) against LU factors (the CPU's
     branch above 2048 unknowns, forced here): cavity128 on one level
     (a 7875-unknown coarse) and upstream's stokes2_3D at 32^3 (3528),
     the branches in turns (LU, inverse, inverse, LU): the cold coarse
     factor by CUDA events, max|I - A X| of the inverse, the replayed
     apply bit for bit the eager one and its time per apply; then
     cavity128's Newton sequence on each branch, interleaved: compute()
     against recompute() (warm_inv on the coarse inverse: polished from
     the last one where its gate passes; LU refactored cold) and
     newton_step against newton_step_warm, with inner iterations and
     true f64 relres;
 30. GMRES's iterations replayed from CUDA graphs (solvers/krylov.py:
     GmresGraphs) against the eager loop, on cavity128 (one level) and
     upstream's stokes2_3D at 32^3 (two levels), refinement solves of
     one b in turns (graph, eager, eager, graph, twice): x equal bit for
     bit with equal inner iterations, the first graph solve's captures
     and the memory its workspace and graphs took, wall and CUDA-event
     us per inner iteration of each side, device busy us and
     synchronizing calls per iteration (torch.profiler), and the
     synchronizing calls of one solve by Python line.

Every other phase runs with the plan disk cache off (HYMLS_PLAN_CACHE
empty), so that its plan builds are cold ones.

Each of the paths 4-6 and 8-27 (phase 8 once per apply, phase 10's
Newton solve and trace apart; in phases 20-21 the solves on ELL
operators launch no DIA kernel and say so; phases 22 and 27 once per
config and run;
phase 23's server is another process, whose launches are not counted
here) is driven with the kernels' launch counts set to 0 just before it
and read just after; each path
whose operator is a DIA operator must have launched the kernel.  Phase
7 takes 2 rounds (medians of 4) and phase 8's times 3 rounds (medians
of 6) so that all phases fit.  The per-phase records are one JSON
line ({"records": ...}); the line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# CPU anchors of the JAX package on synthetic cavity64_Re1000, the same
# on its structured and generic applies (PERF.md): inner f32 iterations
# of the IR Newton step, and the iterations of the plain f64 GMRES solve
ANCHOR_INNER = 75
ANCHOR_F64 = 72
RELRES_OK = 1e-11
# CPU anchors of the JAX package (PERF.md, PR 5): inner f32 iterations
# of newton_step_warm_fn over bench.py's warm sequence on cavity64, per
# step and apply; f64 GMRES iterations of the bordered cavity64 solve;
# max and last lam of the Bratu 64^2 continuation through the fold
ANCHOR_WARM = {"structured": (75, 76, 75, 75), "generic": (76, 76, 76, 75)}
ANCHOR_BORDERED = 72
BRATU_DS = 4.0
BRATU_STEPS = 22
ANCHOR_LAM_MAX = 6.804608946817739
ANCHOR_LAM_LAST = 4.696724384434961

# CPU anchors of the JAX package for phases 11-17 (PERF.md section 4;
# the port's CPU counts are the same unless noted there): inner f32
# iterations of the IR Newton step on stokesB_64, stokes128_L2 and
# stokes32cube_skew_L2; f64 GMRES iterations on cavity64 restarted
# every 30; direct Schur, plain and bordered; stokes_L2 at 8^3 with and
# without the B-grid transform, and its no-dropping variant at 16^3;
# inner iterations with 'Factor Precision' 'f64'
ANCHOR_STOKESB = 7
ANCHOR_STOKES128 = 115
# two levels of f32 factors round otherwise under cuSOLVER and cuBLAS
# than under LAPACK: the card took 109 inner iterations where both
# packages take 115 on the CPU, so this case is held to 10%
STOKES128_BAND = 0.10
# on this ill-conditioned 3-D case the two packages' f32 factors part
# further: 181 / 171 inner and, through the f32 preconditioner, 158 /
# 152 f64 iterations (JAX / port, CPU); the card is held to bench.py's
# own checks and to 15% of the JAX counts
ANCHOR_STOKES32 = 181
ANCHOR_STOKES32_F64 = 158
STOKES32_BAND = 0.15
ANCHOR_RESTART30 = 73
ANCHOR_DIRECT = {"plain": 2, "bordered": 1}
ANCHOR_BGRID = {True: 65, False: 46}
ANCHOR_BGRID_NODROP16 = 2
ANCHOR_FACTOR64 = 76
# CPU anchors of the JAX package for phases 18-21 (tests/_torch_anchors.py
# prints them; the port's CPU counts are the same unless noted): GMRES
# iterations of the deflated projected solve and of the plain solve, on
# the anisotropic Laplace and on the bordered Neumann Laplace at 128^2;
# complex GMRES iterations of (A + 0.5 i I) z = b and of the complex
# bordered solve at 128^2; JDQR outer iterations on Laplace 64^2 (the
# port takes 44 on the CPU); the inner solves of shift_invert_eigs there
# (the port: 55)
DEFL_NX = 128
ANCHOR_DEFLATED, ANCHOR_DEFLATED_PLAIN = 65, 65
ANCHOR_BORDERED_DEFLATED, ANCHOR_BORDERED_DEFLATED_PLAIN = 37, 37
ANCHOR_COMPLEX = 92
ANCHOR_COMPLEX_BORDERED = 91
ANCHOR_JDQR = 46
ANCHOR_SHIFT_INVERT_SOLVES = 56
# JDQR on the cavity Jacobian at Re 1000, 4 values nearest 0: per grid
# size the values the JAX package locks, its outer iterations, and the
# tolerance on the values relative to the largest |lambda| of the four.
# The first value is the pressure null mode, rounding noise of order
# 1e-12: at 64^2 that is 5e-7 of the largest, hence 1e-5 there.
ANCHOR_PAIR = {
    16: ((-6.8414981018e-13, -1.2845503440e-05,
          -1.3933719667e-05 + 3.8031776078e-05j,
          -1.3933719667e-05 - 3.8031776078e-05j), 28, 1e-6),
    64: ((-1.3151893996e-12, -7.5974113497e-07,
          -7.7383087053e-07 + 2.3665094275e-06j,
          -7.7383087053e-07 - 2.3665094275e-06j), 20, 1e-5)}
# CPU anchors of the JAX package for phase 22 (tests/_torch_anchors.py 22;
# the port's CPU counts are the same): per config, per refinement, the
# iterations of every solve, and JDQR's outer iterations on
# laplace1_eigs per refinement (the port's: 44 and 43)
ANCHOR_DRIVER = {
    "laplace1": [[20, 20, 20, 20], [21, 21, 21, 21], [21, 21, 21, 21]],
    "stokes2": [[47, 48, 48, 48]],
    "bordering1": [[26], [36], [37]],
    "deflation1": [[48, 48]],
    "laplace1_eigs": [[21], [21]],
    "stokes2_3D": [[112, 113]]}
ANCHOR_DRIVER_JDQR = [45, 46]
# CPU anchors of the JAX package for phase 27 (tests/_torch_anchors.py 27;
# the port's CPU counts are the same), as ANCHOR_DRIVER; JDQR's outer
# iterations per refinement (the port's: 44, 43; 34; 44)
ANCHOR_SUITE = {
    "stokes4": [[1]], "stokes4_3D": [[1]], "stokes5": [[2]],
    "stokes_L": [[45]], "stokes_THCM": [[50]],
    "deflation1_bordering": [[48, 48, 48, 48]],
    "laplace1_eigs_deflation": [[20], [20]], "laplace_eigs": [[21]],
    "neumann": [[36]], "stokes6": [[29, 29, 29, 29]], "stokes_L3": [[68]],
    "stokes_L4": [[41]], "stokes_THCM3": [[65]], "stokes_THCM4": [[27]],
    "laplace2_eigs": [[20]], "darcy": [[126]], "convdiff": [[36]]}
ANCHOR_SUITE_JDQR = {"laplace1_eigs_deflation": [45, 46],
                     "laplace_eigs": [37], "laplace2_eigs": [45]}
# the 3-D two-level configs on which "Auto" takes the structured apply:
# run once more on the generic one
SUITE_GENERIC = ("stokes_L", "stokes_THCM", "stokes_L3", "stokes_L4",
                 "stokes_THCM3")
# CPU anchors of the JAX package for phase 25 on a virtual mesh of 4
# devices (tests/_torch_anchors.py 25; the port's CPU counts on 4 gloo
# ranks are there too): inner f32 iterations of the distributed IR
# Newton step on cavity64 and stokes128_L2 ('Structured Apply' False)
ANCHOR_DIST_CAVITY64 = 76
ANCHOR_DIST_STOKES128 = 115
# CPU anchors of the JAX package for phase 26 on a virtual mesh of 4
# devices (tests/_torch_anchors.py 26): inner f32 iterations of the IR
# Newton step on the sharded structured apply, cavity64 and stokes128_L2
ANCHOR_SHARDED_CAVITY64 = 75
ANCHOR_SHARDED_STOKES128 = 115
DIST_RANKS = 4
HERE = os.path.dirname(os.path.abspath(__file__))

TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
# dense matvec: f32 sums of up to 8192 products in another order than
# cuBLAS
MV_TOL = 1e-5
MV_SIZES = (2048, 8192, 2047, 300)
# the sentinel gather: the benchmark configurations whose level-0 plans
# it is timed on, the fields timed, and the f64 block apply's columns
# against the block (GEMVs become GEMMs: another summation order;
# tests/test_torch_batched.py holds 1e-13 on the CPU)
GATHER_CONFIGS = ("stokes3d_32_L2", "thcm64x64x8")
GATHER_TIMED = ("int_pos", "node_src")
GATHER_BLOCK_TOL = 1e-11


def log(msg: str) -> None:
    print(msg, flush=True)


def cavity64():
    from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian
    K = cavity_jacobian(64, 64, re=1000.0).tocsr()
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    return K, b


def cavity64_params(structured="Auto"):
    """bench.py:_stokes_params(64, 2, 1, "Cartesian"), with the given
    'Structured Apply' setting."""
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
                           "Structured Apply": structured},
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


def issue_us(fn, calls: int = 100) -> float:
    """Host us per call of `calls` back-to-back calls, no synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return t * 1e6


def build_baseline(baseline_dir):
    """Start nvcc on an earlier tree's csrc/dia_spmv.cu with the
    package's flags; returns (process, library path)."""
    from hymls_tpu_torch.tools.dia_spmv_sweep import start_build
    src = os.path.join(baseline_dir, "hymls_tpu_torch", "csrc",
                       "dia_spmv.cu")
    so = os.path.join(os.path.abspath(baseline_dir),
                      "libdia_spmv_baseline.so")
    return start_build(src, so), so


def hold_dia(bands, x, offs, what):
    """(max abs err, the same relative to max|y|) of the DIA kernel on
    the contiguous copy of `x` against its plain version; raises beyond
    TOL of the type."""
    from hymls_tpu_torch.ops.dia_spmv import (dia_matvec_packed,
                                              dia_matvec_reference)
    y = dia_matvec_packed(bands, x.contiguous(), offs)
    y_ref = dia_matvec_reference(bands, x, offs.offsets)
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    rel = err / max(float(y_ref.abs().max()), 1e-300)
    if not (rel <= TOL[x.dtype]) or not bool(torch.isfinite(y).all()):
        raise RuntimeError(f"dia_spmv {what} disagrees with its plain "
                           f"version: rel err {rel:.3e}")
    return err, rel


def solver_family_matrices():
    """The matrices whose DIA operators phases 18, 19 and 21 launch the
    kernel on: the anisotropic and the Neumann Laplace at 128^2 and
    Laplace 64^2, each with its transpose (setup_deflation's second
    operator)."""
    from hymls_tpu_torch.stencils import laplace2d, laplace2d_neumann
    from hymls_tpu_torch.stencils.generators import _cross2d
    nx, eps = DEFL_NX, 0.01
    mats = {
        f"aniso{nx}": -_cross2d(nx, nx, 2 + 2 * eps, -1.0, -1.0, -eps, -eps),
        f"neumann{nx}": laplace2d_neumann(nx, nx),
        "laplace64": laplace2d(64, 64)}
    out = {}
    for name, K in mats.items():
        out[name] = K.tocsr()
        out[name + "^T"] = K.T.tocsr()
    return out


def driver_matrices():
    """The matrices of every refinement of phase 22's and phase 27's
    configs, as the driver builds them, each with its transpose
    (setup_deflation's second operator); a matrix equal to one listed
    before it is left out."""
    import hashlib
    import hymls_tpu_torch.driver as drv
    from hymls_tpu_torch.config import load_xml
    from hymls_tpu_torch.tools.driver_cases import (SUITE_CONFIGS,
                                                    driver_params,
                                                    refined_matrices)
    out, seen = {}, set()
    for name in (*ANCHOR_DRIVER, *SUITE_CONFIGS):
        for p, K in refined_matrices(drv, driver_params(load_xml, name)):
            prob = p.sublist("Problem")
            size = "x".join(str(prob.get(k)) for k in ("nx", "ny", "nz")
                            if prob.get("Dimension", 2) > 2 or k != "nz")
            for tag, M in (("", K.tocsr()), ("^T", K.T.tocsr())):
                M.sort_indices()
                h = hashlib.sha256()
                for a in (M.indptr, M.indices, M.data):
                    h.update(np.ascontiguousarray(a).tobytes())
                if (M.shape, h.digest()) not in seen:
                    seen.add((M.shape, h.digest()))
                    out[f"{name} {size}{tag}"] = M
    return out


def check_dia_solver_shapes(device):
    """Phase 3: the DIA kernel against its plain version on the
    operators of the solver family's and the driver's paths, built by
    `make_operator` as Solver builds them, in f64 (the paths' type) and f32, with an
    aligned and an unaligned x.  No timing.  Returns the largest
    (abs, rel) error."""
    from hymls_tpu_torch.ops.spmv import DiaOperator, make_operator

    rng = np.random.default_rng(13)
    worst = (0.0, 0.0)
    for name, K in {**solver_family_matrices(),
                    **driver_matrices()}.items():
        op = make_operator(K, dtype=torch.float64, device=device)
        if not isinstance(op, DiaOperator):
            raise RuntimeError(f"{name}: make_operator gave "
                               f"{type(op).__name__}, not a DIA operator")
        b64, offs = op.prepare(op.vals), op.packed
        n = K.shape[0]
        xs = rng.standard_normal(n + 1)
        rels = {}
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            bands = b64.to(dtype)
            buf = torch.as_tensor(xs, dtype=dtype, device=device)
            errs = [hold_dia(bands, xv, offs, f"{tag} {name} ({path} x)")
                    for path, xv in (("aligned", buf[:n].clone()),
                                     ("offset", buf[1:]))]
            rels[tag] = max(e[1] for e in errs)
            worst = (max(worst[0], *(e[0] for e in errs)),
                     max(worst[1], rels[tag]))
        log(f"dia_spmv {name}: n={n} k={offs.k} max|off|="
            f"{max(abs(o) for o in offs.offsets)}: rel err f64 "
            f"{rels['f64']:.2e} (tol {TOL[torch.float64]:g}), f32 "
            f"{rels['f32']:.2e} (tol {TOL[torch.float32]:g}), aligned and "
            f"offset x")
    return worst


def check_dia_kernel(device, baseline=None):
    """Phase 3: the DIA kernel against its plain version at every shape
    of the sweep, in f32 and f64, with x at the start of its buffer, one
    element into it (not 16-byte aligned) and as a view of stride 2
    (refused, then taken as a contiguous copy); per shape and type
    the device time per launch by CUDA-graph replay of the kernel, of
    cuSPARSE's CSR SpMV (torch.mv on a sparse CSR tensor of the same
    matrix) and, given `baseline`, of the earlier kernel, beside the
    bound; the call time with host issue and the host issue alone for
    the kernel and for cuSPARSE."""
    from hymls_tpu_torch.ops.spmv import DiaOperator
    from hymls_tpu_torch.ops.dia_spmv import (dia_matvec_packed,
                                              dia_matvec_reference)
    from hymls_tpu_torch.tools.dia_spmv_sweep import (
        SWEEP, bound, caller, capture, replay_us, sweep_matrix)

    rng = np.random.default_rng(11)
    one = torch.zeros(1, device=device)
    sweep = {}
    for name in SWEEP:
        t0 = time.perf_counter()
        K = sweep_matrix(name)
        op = DiaOperator(K, dtype=torch.float64, device=device)
        b64 = op.prepare(op.vals)
        offs = op.packed
        n, k = K.shape[0], offs.k
        crow = torch.as_tensor(K.indptr.astype(np.int32), device=device)
        col = torch.as_tensor(K.indices.astype(np.int32), device=device)
        xs = rng.standard_normal(n + 1)
        log(f"dia_spmv sweep {name}: n={n} k={k} max|off|="
            f"{max(abs(o) for o in offs.offsets)} nnz={K.nnz} (built in "
            f"{time.perf_counter() - t0:.1f} s)")
        rec = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
            bands = b64.to(dtype)
            buf = torch.as_tensor(xs, dtype=dtype, device=device)
            x = buf[:n].clone()
            x_odd = buf[1:]                  # not 16-byte aligned
            A = torch.sparse_csr_tensor(
                crow, col, torch.as_tensor(K.data, dtype=dtype,
                                           device=device), (n, n))
            # the real part of a complex tensor: a view with stride 2,
            # as the complex solves hand it on.  The wrapper must refuse
            # it, and take its contiguous copy.
            x_strided = torch.complex(x, x.flip(0)).real
            try:
                dia_matvec_packed(bands, x_strided, offs)
            except ValueError:
                pass
            else:
                raise RuntimeError(f"dia_spmv {tag} {name}: the wrapper "
                                   f"took an x of stride 2")
            errs = {path: hold_dia(bands, xv, offs,
                                   f"{tag} {name} ({path} x)")
                    for path, xv in (("aligned", x), ("offset", x_odd),
                                     ("strided", x_strided))}

            def kernel():
                return dia_matvec_packed(bands, x, offs)

            def library():
                return torch.mv(A, x)

            # the yardsticks compute the same function; cuSPARSE sums in
            # another order, hence 10x the kernel's tolerance
            y = kernel()
            yardsticks = {"library": (library, 10 * TOL[dtype])}
            if baseline is not None:
                yardsticks["baseline"] = (
                    caller(baseline["spmv"][dtype], bands, x, offs),
                    TOL[dtype])
            diff = {}
            for what, (fn, tol) in yardsticks.items():
                diff[what] = float((fn() - y).abs().max()) / max(
                    float(y.abs().max()), 1e-300)
                if not diff[what] <= tol:
                    raise RuntimeError(f"{what} dia_spmv {tag} {name} "
                                       f"disagrees with the kernel: rel "
                                       f"diff {diff[what]:.3e}")
            graphs = {"kernel": capture(kernel),
                      "floor": capture(lambda: one.zero_())}
            graphs.update({what: capture(fn)
                           for what, (fn, _) in yardsticks.items()})
            if name == "cavity64":
                graphs["plain"] = capture(
                    lambda: dia_matvec_reference(bands, x, offs.offsets))
            dev = replay_us(graphs)
            del graphs, yardsticks
            b_ms, b_by = bound(n, k, dtype)
            r = {"device_us": dev["kernel"], "bound_us": b_ms * 1e3,
                 "bound_by": b_by,
                 "roofline_share": b_ms * 1e3 / dev["kernel"],
                 "floor_us": dev["floor"],
                 "library_us": dev["library"],
                 "library_rel_diff": diff["library"],
                 "baseline_device_us": dev.get("baseline"),
                 "plain_device_us": dev.get("plain"),
                 "call_us": event_ms(kernel, reps=20) * 1e3,
                 "host_issue_us": issue_us(kernel),
                 "library_call_us": event_ms(library, reps=20) * 1e3,
                 "library_host_issue_us": issue_us(library),
                 "max_abs_err": max(e[0] for e in errs.values()),
                 "max_rel_err": max(e[1] for e in errs.values())}
            if name == "cavity64":
                r["plain_call_us"] = event_ms(
                    lambda: dia_matvec_reference(bands, x, offs.offsets),
                    reps=20) * 1e3
            base = (f", baseline {r['baseline_device_us']:.3f}"
                    if baseline is not None else "")
            log(f"dia_spmv {tag} {name}: rel err "
                f"{errs['aligned'][1]:.2e}, offset x "
                f"{errs['offset'][1]:.2e}, strided x (refused, then its "
                f"contiguous copy) {errs['strided'][1]:.2e} (tol "
                f"{TOL[dtype]:g}); device "
                f"us/launch: kernel {r['device_us']:.3f}{base}, cuSPARSE "
                f"{r['library_us']:.3f} (rel diff {diff['library']:.1e}), "
                f"empty launch {r['floor_us']:.3f}; bound "
                f"{r['bound_us']:.3f} ({b_by}), roofline share "
                f"{r['roofline_share']:.3f}; call {r['call_us']:.2f} / "
                f"cuSPARSE {r['library_call_us']:.2f} us, host issue "
                f"{r['host_issue_us']:.2f} / "
                f"{r['library_host_issue_us']:.2f} us")
            rec[tag] = r
            del A, bands, x, x_odd, x_strided, buf
        sweep[name] = rec
        del op, b64, crow, col, K
        torch.cuda.empty_cache()
    return sweep


#: the block sizes of the deflation setups' DIA products: the k projected
#: solves of phases 18 (k = 8), 19 (6) and 22/27 (deflation1 and
#: deflation1_bordering 10, laplace1_eigs_deflation 5), and the
#: subspace iteration's kp = k + 6 where a mass matrix or the B-grid
#: transform puts a DIA product into the block apply
MATMAT_BLOCKS = (5, 6, 8, 10, 11, 12, 14, 16)
#: block sizes below those, so that the correctness loop reaches the
#: kernel's smaller vector groups (VB = 1, 2 and 4) in every bucket
MATMAT_COVER_BLOCKS = (1, 2, 3)
#: one operator of random bands for each band bucket of the kernel (4 to
#: 48 bands), at a ragged n, so that every instance the launcher can pick
#: is run: k bands at distinct random offsets within and beyond n
SYNTH_BUCKETS = (4, 8, 12, 16, 20, 24, 32, 40, 48)
SYNTH_N = 3001
#: dia_matmat against its plain version, per element, in units of the
#: largest partial sum (sum_k |bands * x| bounds every partial sum): 4
#: ulp of the type.  The plain version rounds every product, the kernel
#: fuses it, so the two part by a few ulp of that sum; relative to max|y|
#: the f32 error passes 2e-7 where the terms cancel (stokes_L3's
#: transpose on the card)
MATMAT_TOL = {torch.float64: 4 * 2.0 ** -52, torch.float32: 4 * 2.0 ** -23}


def hold_dia_matmat(bands, X, offs, what):
    """dia_matmat against its plain version and each row against K1 on
    that row; raises beyond MATMAT_TOL or where a row differs from K1 in
    any bit.  Returns (max abs err, err in the tolerance's scale)."""
    from hymls_tpu_torch.ops.dia_spmv import (dia_matmat_packed,
                                              dia_matmat_reference,
                                              dia_matvec_packed)
    Y = dia_matmat_packed(bands, X, offs)
    Y_ref = dia_matmat_reference(bands, X, offs.offsets)
    torch.cuda.synchronize()
    diff = (Y - Y_ref).abs()
    scale = dia_matmat_reference(bands.abs(), X.abs(), offs.offsets)
    err = float((diff / scale.clamp_min(torch.finfo(X.dtype).tiny)).max())
    if not (err <= MATMAT_TOL[X.dtype]) or not bool(torch.isfinite(Y).all()):
        raise RuntimeError(f"dia_matmat {what} disagrees with its plain "
                           f"version: {err:.3e}")
    for j in range(X.shape[0]):
        if not torch.equal(Y[j], dia_matvec_packed(bands, X[j], offs)):
            raise RuntimeError(f"dia_matmat {what}: row {j} differs from "
                               f"dia_spmv on that row")
    return float(diff.max()), err


def matmat_instance(n, nvec, k, dtype):
    """(type, band bucket, VB, rounds): the kernel instance the
    multi-column launcher runs for this shape."""
    from hymls_tpu_torch.ops.dia_spmv import matmat_plan
    p = matmat_plan(n, nvec, k, dtype)
    return (str(dtype)[6:], p["bucket"], p["vb"], p["rounds"])


def synthetic_operators(rng):
    """{name: (f64 bands, DiaOffsets)}: SYNTH_BUCKETS' operators of
    random bands at n = SYNTH_N."""
    from hymls_tpu_torch.ops.dia_spmv import DiaOffsets
    n = SYNTH_N
    out = {}
    for k in SYNTH_BUCKETS:
        offs = rng.choice(np.arange(-n - 2, n + 3), size=k, replace=False)
        out[f"random {k} bands"] = (rng.standard_normal((k, n)),
                                    DiaOffsets(offs.tolist()))
    return out


def check_dia_matmat(device, baseline=None):
    """Phase 3: K1's multi-column form against its plain version on every
    DIA operator of phases 18, 19, 21, 22 and 27 (as make_operator
    builds them, with their transposes) at every block size of
    MATMAT_COVER_BLOCKS and MATMAT_BLOCKS, and on SYNTH_BUCKETS' random
    operators, in f64 and f32, each row also against K1 bit for bit;
    every kernel instance the launcher can pick (band count 1-48, B
    1-64, both types) must have run.  Then, at MATMAT_SWEEP's shapes and
    block sizes, the device time per launch by CUDA-graph replay beside
    its bound, an empty launch, B launches of K1 on the rows, the plain
    version, cuSPARSE's SpMM (torch.sparse.mm on the CSR tensor, timed
    here only) and, given `baseline`, the earlier tree's multi-column
    entry (which must give the same bits); and the device us each added
    vector costs between a shape's two block sizes."""
    from hymls_tpu_torch.ops.dia_spmv import (dia_matmat_packed,
                                              dia_matmat_reference,
                                              dia_matvec_packed,
                                              matmat_plan)
    from hymls_tpu_torch.ops.spmv import make_operator
    from hymls_tpu_torch.tools.dia_spmv_sweep import (
        MATMAT_SWEEP, bound_mm, caller_mm, capture, matmat_matrix,
        replay_us)

    rng = np.random.default_rng(17)
    mats = {**solver_family_matrices(), **driver_matrices()}
    worst = {torch.float64: (0.0, 0.0), torch.float32: (0.0, 0.0)}
    ran = set()
    cases = {}
    for name, K in mats.items():
        op = make_operator(K, dtype=torch.float64, device=device)
        cases[name] = (op.prepare(op.vals), op.packed,
                       MATMAT_COVER_BLOCKS + MATMAT_BLOCKS)
        del op
    for name, (b, offs) in synthetic_operators(rng).items():
        cases[name] = (torch.as_tensor(b, device=device), offs,
                       MATMAT_COVER_BLOCKS + (5, 8))
    for name, (b64, offs, blocks) in cases.items():
        n = b64.shape[1]
        X64 = torch.as_tensor(rng.standard_normal((max(blocks), n)),
                              device=device)
        for dtype in (torch.float64, torch.float32):
            bands, Xd = b64.to(dtype), X64.to(dtype)
            for nb in blocks:
                e = hold_dia_matmat(bands, Xd[:nb].contiguous(), offs,
                                    f"{name} B={nb} {dtype}")
                ran.add(matmat_instance(n, nb, offs.k, dtype))
                worst[dtype] = (max(worst[dtype][0], e[0]),
                                max(worst[dtype][1], e[1]))
    reachable = {matmat_instance(SYNTH_N, nb, k, dtype)
                 for k in range(1, 49) for nb in range(1, 65)
                 for dtype in (torch.float32, torch.float64)}
    if reachable - ran:
        raise RuntimeError(f"dia_matmat: the correctness loop never ran the "
                           f"instances {sorted(reachable - ran)}")
    log(f"dia_matmat: {len(mats)} operators x B in "
        f"{list(MATMAT_COVER_BLOCKS + MATMAT_BLOCKS)} and "
        f"{len(SYNTH_BUCKETS)} random ones (n = {SYNTH_N}, "
        f"{list(SYNTH_BUCKETS)} bands): err f64 "
        f"{worst[torch.float64][1] / 2.0 ** -52:.2f}, f32 "
        f"{worst[torch.float32][1] / 2.0 ** -23:.2f} ulp of sum|terms| "
        f"(tol 4); every row equal to dia_spmv's bit for bit; all "
        f"{len(reachable)} instances the launcher can pick ran "
        f"(type, bucket, VB, rounds): {sorted(reachable)}")
    del cases

    one = torch.zeros(1, device=device)
    timed, per_vec = {}, {}
    for name, blocks in MATMAT_SWEEP:
        K = mats[name] if name in mats else matmat_matrix(name)
        op = make_operator(K, dtype=torch.float64, device=device)
        b64, offs, n = op.prepare(op.vals), op.packed, K.shape[0]
        crow = torch.as_tensor(K.indptr.astype(np.int32), device=device)
        col = torch.as_tensor(K.indices.astype(np.int32), device=device)
        # fewer launches a graph beyond L2, where one launch is ~50 us and
        # the plain version ~1 ms
        launches = 20 if n > 100000 else 100
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            bands = b64.to(dtype)
            A = torch.sparse_csr_tensor(
                crow, col, torch.as_tensor(K.data, dtype=dtype,
                                           device=device), (n, n))
            for nb in blocks:
                X = torch.as_tensor(rng.standard_normal((nb, n)),
                                    dtype=dtype, device=device)
                XT = X.T.contiguous()
                Y = dia_matmat_packed(bands, X, offs)
                lib_diff = float((torch.sparse.mm(A, XT).T - Y).abs().max()
                                 ) / max(float(Y.abs().max()), 1e-300)
                if not lib_diff <= 10 * TOL[dtype]:
                    raise RuntimeError(f"cuSPARSE SpMM {name} B={nb} {tag} "
                                       f"disagrees with dia_matmat: "
                                       f"{lib_diff:.3e}")
                rows = [X[j] for j in range(nb)]
                graphs = {
                    "kernel": lambda: dia_matmat_packed(bands, X, offs),
                    "floor": lambda: one.zero_(),
                    "k1_rows": lambda: [
                        dia_matvec_packed(bands, r, offs) for r in rows],
                    "plain": lambda: dia_matmat_reference(
                        bands, X, offs.offsets)}
                if baseline is not None and dtype in baseline["spmm"]:
                    base = caller_mm(baseline["spmm"][dtype], bands, X, offs)
                    if not torch.equal(base(), Y):
                        raise RuntimeError(f"the baseline dia_matmat {name} "
                                           f"B={nb} {tag} differs from the "
                                           f"kernel")
                    graphs["baseline"] = base
                graphs = {k: capture(fn, launches)
                          for k, fn in graphs.items()}
                try:
                    graphs["library"] = capture(
                        lambda: torch.sparse.mm(A, XT), launches)
                except RuntimeError as e:
                    # timed with its host issue instead (events around
                    # back-to-back calls), and said so
                    log(f"cuSPARSE SpMM is not capturable ({e}); timed "
                        f"by events")
                dev = replay_us(graphs, launches=launches)
                if "library" not in dev:
                    dev["library"] = event_ms(
                        lambda: torch.sparse.mm(A, XT), reps=20) * 1e3
                del graphs
                b_ms, b_by = bound_mm(n, offs.k, nb, dtype)
                plan = matmat_plan(n, nb, offs.k, dtype)
                r = {"device_us": dev["kernel"], "bound_us": b_ms * 1e3,
                     "bound_by": b_by,
                     "roofline_share": b_ms * 1e3 / dev["kernel"],
                     "baseline_us": dev.get("baseline"),
                     "floor_us": dev["floor"],
                     "k1_rows_us": dev["k1_rows"],
                     "plain_us": dev["plain"], "library_us": dev["library"],
                     "library_rel_diff": lib_diff, "plan": plan}
                key = f"{name} B={nb} {tag}"
                timed[key] = r
                step = ""
                if nb == blocks[1]:
                    first = timed[f"{name} B={blocks[0]} {tag}"]
                    per_vec[f"{name} {tag}"] = (
                        (r["device_us"] - first["device_us"])
                        / (blocks[1] - blocks[0]))
                    step = (f"; per added vector (B = {blocks[0]} -> "
                            f"{blocks[1]}) {per_vec[f'{name} {tag}']:.3f}")
                base_txt = (f", baseline {r['baseline_us']:.3f}"
                            if r["baseline_us"] is not None else "")
                log(f"dia_matmat {tag} {name} B={nb}: n={n} k={offs.k} "
                    f"(VB {plan['vb']}, {plan['threads']} threads x "
                    f"{plan['blocks']} blocks); device us/launch: kernel "
                    f"{r['device_us']:.3f}{base_txt}, empty launch "
                    f"{r['floor_us']:.3f}, {nb} K1 launches "
                    f"{r['k1_rows_us']:.3f}, plain {r['plain_us']:.3f}, "
                    f"cuSPARSE SpMM {r['library_us']:.3f} (rel diff "
                    f"{lib_diff:.1e}); bound {r['bound_us']:.3f} "
                    f"({b_by}), roofline share "
                    f"{r['roofline_share']:.3f}{step}")
                del X, XT, Y, rows
            del A
        del op, b64, crow, col, K
        torch.cuda.empty_cache()
    return {"max_abs_err": max(w[0] for w in worst.values()),
            "f64_err_ulp": worst[torch.float64][1] / 2.0 ** -52,
            "f32_err_ulp": worst[torch.float32][1] / 2.0 ** -23,
            "instances": len(reachable), "timed": timed,
            "us_per_added_vector": per_vec}


def check_dense_matvec(device):
    """Phase 3: the dense matvec kernel against its plain version on
    the card, at the probe's shape and on ragged ones; at n = 2048 and
    8192 also the device time per launch by CUDA-graph replay, of the
    kernel and of torch.matmul (the plain version, one cuBLAS call),
    beside the bound."""
    from hymls_tpu_torch.ops.dense_matvec import (dense_matvec,
                                                  dense_matvec_reference)
    from hymls_tpu_torch.tools.dia_spmv_sweep import (HBM_BYTES_PER_S,
                                                      capture, replay_us)

    rng = np.random.default_rng(12)
    rec = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for n in MV_SIZES:
        M = torch.as_tensor(rng.standard_normal((n, n)) / np.sqrt(n),
                            dtype=torch.float32, device=device)
        x = torch.as_tensor(rng.standard_normal((n, 1)),
                            dtype=torch.float32, device=device)
        y = dense_matvec(M, x)
        y_ref = dense_matvec_reference(M, x)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        rel = err / max(float(y_ref.abs().max()), 1e-300)
        ms = event_ms(lambda: dense_matvec(M, x))
        plain_ms = event_ms(lambda: dense_matvec_reference(M, x))
        log(f"dense_matvec n={n}: max|y-y_ref|={err:.3e} rel={rel:.3e} "
            f"(tol {MV_TOL:g}); kernel {ms * 1e3:.2f} us, plain torch "
            f"{plain_ms * 1e3:.2f} us per call")
        if tuple(y.shape) != (n, 1) or not bool(torch.isfinite(y).all()) \
                or not rel <= MV_TOL:
            raise RuntimeError(f"dense_matvec n={n} disagrees with its "
                               f"plain version: rel err {rel:.3e}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["max_rel_err"] = max(rec["max_rel_err"], rel)
        rec[n] = {"ms": ms, "plain_ms": plain_ms}
        if n in (2048, 8192):
            dev = replay_us({"kernel": capture(lambda: dense_matvec(M, x)),
                             "plain": capture(
                                 lambda: dense_matvec_reference(M, x))})
            b_us = (n * n + 2 * n) * 4 / HBM_BYTES_PER_S * 1e6
            rec[n].update(device_us=dev["kernel"],
                          plain_device_us=dev["plain"], bound_us=b_us)
            log(f"dense_matvec n={n}: device us/launch kernel "
                f"{dev['kernel']:.3f}, torch.matmul {dev['plain']:.3f}; "
                f"bound {b_us:.3f} (bytes), roofline share "
                f"{b_us / dev['kernel']:.3f}")
    return rec


def bench_config(name, device, dtype=torch.float32, **problem):
    """The benchmark configuration `name` (portbench/configs, its
    parameters only) on the generic apply, at another size where
    `problem` says so: (K, its Preconditioner on `device` with plans
    built, nothing factored)."""
    from hymls_tpu_torch import Params, Preconditioner
    from hymls_tpu_torch.stencils import create_matrix, create_testvector
    with open(os.path.join(HERE, "portbench", "configs",
                           name + ".json")) as f:
        d = json.load(f)["params"]
    d["Problem"].update(problem)
    d["Preconditioner"]["Structured Apply"] = False
    p = Params(d)
    K = create_matrix(p)
    return K, Preconditioner(K, p, testvector=create_testvector(p, K),
                             dtype=dtype, device=device)


def check_gather(device):
    """Phase 3: the sentinel gather kernel against its plain version on
    the card, at the generic apply's level-0 plans of the 3-D and THCM
    cells, timed by CUDA-graph replay at `int_pos` and `node_src`; then
    the block apply through it under vmap."""
    from hymls_tpu_torch.ops.gather import (sentinel_gather,
                                            sentinel_gather_reference)
    from hymls_tpu_torch.tools.dia_spmv_sweep import (HBM_BYTES_PER_S,
                                                      capture, replay_us)
    from hymls_tpu_torch.utils import timings

    def gathers():
        c = timings.counter_snapshot()
        return c.get("hymls.gather.kernel", 0), c.get("hymls.gather.plain", 0)

    def applies():
        c = timings.counter_snapshot()
        return c.get("hymls.apply.graph_captures", 0) + \
            c.get("hymls.apply.eager", 0)

    rng = np.random.default_rng(23)
    rec = {"timed": {}, "fields_held": 0, "per_apply": {}}
    one = torch.zeros(1, device=device)
    for name in GATHER_CONFIGS:
        t0 = time.perf_counter()
        K, P = bench_config(name, device)
        dp, plan = P.generic_plans[0], P.plans[0]
        n_sep = plan.n_sep
        # each index field's source length: what `_apply_level` gathers
        # it from
        src_len = {
            "int_pos": K.shape[0], "sep_pos_in_nodes": K.shape[0],
            "sep_from_sd": dp["sd_sep_pos"].numel(),
            "sd_sep_pos": n_sep, "blk_pos": n_sep, "vsum_pos": n_sep,
            "w_pos": n_sep, "blk_inv_idx": dp["blk_pos"].numel(),
            "vsum_slot": dp["vsum_pos"].numel(),
            "ot_row_of": dp["w_vals"].shape[0],
            "node_src": dp["int_pos"].numel() + n_sep}
        log(f"gather {name}: level-0 plans in "
            f"{time.perf_counter() - t0:.1f} s, n {K.shape[0]}, n_sep "
            f"{n_sep}")
        for field, L in src_len.items():
            idx = dp[field]
            if idx.numel() and not (int(idx.min()) >= 0
                                    and int(idx.max()) <= L):
                raise RuntimeError(f"gather {name} {field}: offsets "
                                   f"outside [0, {L}]")
            for dtype in (torch.float32, torch.float64):
                src = torch.as_tensor(rng.standard_normal(L), dtype=dtype,
                                      device=device)
                block = torch.as_tensor(rng.standard_normal((4, L)),
                                        dtype=dtype, device=device)
                before = gathers()
                got = sentinel_gather(src, idx)
                got_b = torch.func.vmap(
                    lambda v: sentinel_gather(v, idx))(block)
                k, pl = (a - b for a, b in zip(gathers(), before))
                torch.cuda.synchronize()
                if not (torch.equal(got, sentinel_gather_reference(src, idx))
                        and torch.equal(got_b, sentinel_gather_reference(
                            block, idx))) or (k, pl) != (2, 0):
                    raise RuntimeError(
                        f"gather {name} {field} {dtype}: the kernel "
                        f"disagrees with its plain version (or counted "
                        f"{k} kernel, {pl} plain calls, not 2 and 0)")
                rec["fields_held"] += 1
        for field in GATHER_TIMED:
            idx = dp[field]
            src = torch.as_tensor(rng.standard_normal(src_len[field]),
                                  dtype=torch.float32, device=device)
            dev = replay_us({
                "kernel": capture(lambda: sentinel_gather(src, idx)),
                "plain": capture(
                    lambda: sentinel_gather_reference(src, idx)),
                "empty": capture(lambda: one.zero_())})
            b_us = idx.numel() * (8 + 4 + 4) / HBM_BYTES_PER_S * 1e6
            r = rec["timed"][f"{name} {field}"] = {
                "outputs": idx.numel(), "src": src_len[field],
                "device_us": dev["kernel"], "plain_us": dev["plain"],
                "floor_us": dev["empty"], "bound_us": b_us,
                "roofline_share": b_us / dev["kernel"]}
            log(f"gather {name} {field} ({idx.numel()} outputs from "
                f"{src_len[field]}): device us/launch kernel "
                f"{r['device_us']:.3f}, plain version {r['plain_us']:.3f}, "
                f"empty launch {r['floor_us']:.3f}; bound {b_us:.3f} "
                f"(bytes), roofline share {r['roofline_share']:.3f}")
        # the launches of one apply of the cell: its first apply runs
        # the body twice, a warm-up and the capture
        P.compute()
        x = torch.as_tensor(rng.standard_normal(K.shape[0]),
                            dtype=P.dtype, device=device)
        before, a0 = gathers(), applies()
        P.apply_fn(P.factors, x)
        k, pl = (a - b for a, b in zip(gathers(), before))
        runs = applies() - a0 + 1
        want = sum(9 + 4 * p.apply_ot for p in P.plans)
        rec["per_apply"][name] = k / runs
        log(f"gather {name}: {k} kernel and {pl} plain gathers in the "
            f"{runs} runs of its first apply ({P.max_level} levels), "
            f"{k / runs:g} an apply (plan: {want})")
        if pl or k != runs * want:
            raise RuntimeError(f"gather {name}: the apply launched {k} "
                               f"kernel and {pl} plain gathers in {runs} "
                               f"runs, not {want} kernel gathers a run")
        del P, dp
        torch.cuda.empty_cache()

    # the block apply on the card: vmap of the generic apply, one
    # gather launch per gather for the whole block
    _K, P = bench_config(GATHER_CONFIGS[0], device, torch.float64, nx=16,
                         ny=16, nz=16)
    P.compute()
    X = torch.as_tensor(rng.standard_normal((3, _K.shape[0])),
                        dtype=torch.float64, device=device)
    before = gathers()
    Y = P.apply_fn(P.factors, X)
    block_k, block_pl = (a - b for a, b in zip(gathers(), before))
    cols = torch.stack([P.apply_fn(P.factors, x) for x in X])
    torch.cuda.synchronize()
    err = float((Y - cols).abs().max() / cols.abs().max())
    log(f"gather: f64 block apply (B = 3, 16^3, {P.max_level} levels) vs "
        f"its columns {err:.3e} (tol {GATHER_BLOCK_TOL:g}); its capture "
        f"made {block_k} kernel and {block_pl} plain gathers")
    if not err <= GATHER_BLOCK_TOL or block_pl or block_k <= 0:
        raise RuntimeError("gather: the block apply on the card is wrong or "
                           "did not gather through the kernel")
    rec.update(block_apply_rel_err=err, block_apply_launches=block_k)
    return rec


def drive_probe(device):
    """Phase 4: the loop-pathology probe; returns ms per iteration per
    variant at n = 2048, the n = 8192 two-matvec variants, and the
    floors."""
    from hymls_tpu_torch.tools import loop_pathology_bench as lp

    fl = lp.floors(lp.N, device=device)
    res, outs = lp.run_probe(lp.N, device=device)
    big, outs_big = lp.run_probe(8192, ("torch2", "kernel2"), device=device)
    log(f"probe: copy bandwidth {fl['bw_32MB'] / 1e9:.1f} GB/s on 32 MB, "
        f"{fl['bw_256MB'] / 1e9:.1f} GB/s on 256 MB; floor of the "
        f"2-matvec body {fl['floor_ms']:.4f} ms at n = {lp.N}, "
        f"{fl['floor_8192_ms']:.4f} ms at n = 8192")
    for n, r, o in ((lp.N, res, outs), (8192, big, outs_big)):
        for k, v in r.items():
            log(f"probe n={n} {k:10s} {v:.4f} ms/iter")
        for k, gap in lp.iterate_gaps(o).items():
            log(f"probe n={n} {k}: final iterate {gap:.3e} from "
                f"{lp.TWINS[k]}'s (tol {lp.ITERATE_TOL:g})")
    return res, big, fl


def drive_main_path(device, structured):
    """Phases 5-6: the IR Newton step on cavity64_Re1000 with the given
    'Structured Apply' setting; returns the solver, the result and the
    checks' numbers."""
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    from hymls_tpu_torch.stencils import create_testvector

    K, b = cavity64()
    params = cavity64_params(structured)
    tv = create_testvector(params, K)
    t0 = time.perf_counter()
    S = IterativeRefinementSolver(K, params, testvector=tv, device=device)
    t_init = time.perf_counter() - t0
    S.compute()
    with counted_factorize(S.precond) as gathers:
        res = S.newton_step(S.op64.vals, S.solver.op.vals, b)
    x = res.x.cpu().numpy()
    relres = float(np.linalg.norm(K @ x - b) / np.linalg.norm(b))
    return K, b, S, res, relres, t_init, gathers


@contextlib.contextmanager
def counted_factorize(P):
    """The sentinel gather's launches inside the block, split into those
    of `P.factorize` and the rest (the solve's applies, counted at
    capture and warm-up): yields the dict it fills on exit."""
    from hymls_tpu_torch.ops.gather import sentinel_gather

    rec = {"factorize": 0}
    factorize = P.factorize

    def counted(*a, **kw):
        n0 = sentinel_gather.launches
        out = factorize(*a, **kw)
        rec["factorize"] += sentinel_gather.launches - n0
        return out

    n0 = sentinel_gather.launches
    P.factorize = counted
    try:
        yield rec
    finally:
        del P.factorize
        rec["solve"] = sentinel_gather.launches - n0 - rec["factorize"]


def reset_counts() -> None:
    """Every kernel's launch count set to 0, just before a path runs."""
    from hymls_tpu_torch.ops.dense_matvec import dense_matvec
    from hymls_tpu_torch.ops.dia_spmv import dia_matmat, dia_matvec
    from hymls_tpu_torch.ops.gather import sentinel_gather
    dia_matvec.launches = dia_matmat.launches = dense_matvec.launches = 0
    sentinel_gather.launches = 0


@contextlib.contextmanager
def deflation_setups():
    """Records each Solver.setup_deflation run inside the block (a
    'Deflated Subspace Dimension' above 0): its seconds split into the
    subspace iteration and the k projected solves, the block applies,
    the batched GMRES's iterations per column, and the launches of K1
    (dia_spmv) and of its multi-column form (dia_matmat) inside it."""
    import hymls_tpu_torch.solvers.deflation as defl
    from hymls_tpu_torch.ops.dia_spmv import dia_matmat, dia_matvec
    from hymls_tpu_torch.solvers import krylov
    from hymls_tpu_torch.solvers.solver import Solver

    recs = []
    setup, space, gmres_b = (Solver.setup_deflation,
                             defl.compute_deflation_space_device,
                             krylov.gmres_batched)

    def timed_space(*a, **kw):
        t, V = wall_median(lambda: space(*a, **kw), 1)
        recs[-1]["subspace_s"] = t
        return V

    def counted_gmres(*a, **kw):
        res = gmres_b(*a, **kw)
        recs[-1]["gmres_iters"] = res.iters.tolist()
        return res

    def timed_setup(self, *a, **kw):
        k = self.params.sublist("Solver").get(
            "Deflated Subspace Dimension", 0)
        if k <= 0:
            return setup(self, *a, **kw)
        rec = {"k": k, "subspace_s": 0.0, "gmres_iters": []}
        recs.append(rec)
        k1, mm = dia_matvec.launches, dia_matmat.launches
        t, out = wall_median(lambda: setup(self, *a, **kw), 1)
        info = self._defl_info
        kp = min(k + 6, max(self.op.n - 2, 1))
        rec.update(setup_s=t, projected_solves_s=t - rec["subspace_s"],
                   applies=info.get("applies"), rel=info.get("rel"),
                   block_applies=info.get("applies", 0) // kp,
                   k1_launches=dia_matvec.launches - k1,
                   matmat_launches=dia_matmat.launches - mm)
        return out

    Solver.setup_deflation = timed_setup
    defl.compute_deflation_space_device = timed_space
    krylov.gmres_batched = counted_gmres
    try:
        yield recs
    finally:
        Solver.setup_deflation = setup
        defl.compute_deflation_space_device = space
        krylov.gmres_batched = gmres_b


def setup_line(rec) -> str:
    """One deflation setup of `deflation_setups` in words."""
    its = rec["gmres_iters"]
    return (f"setup {rec['setup_s']:.4f} s (subspace iteration "
            f"{rec['subspace_s']:.4f} s: {rec['block_applies']} block "
            f"applies, {rec['applies']} column applies, rel "
            f"{rec['rel']:.2e}; the {rec['k']} projected solves "
            f"{rec['projected_solves_s']:.4f} s in one batched GMRES of "
            f"{max(its) if its else 0} iterations, per column {its}); "
            f"launches in the setup: dia_spmv {rec['k1_launches']}, "
            f"dia_matmat {rec['matmat_launches']}")


def check_main_path(device, structured, tag):
    """Drive one path of phases 5-6 with the launch counts set to 0
    just before it; check its anchors; returns (K, b, S, launches,
    gathers): K1's launches and the sentinel gather's in the Newton
    step, split into its factorization's and its solve's."""
    from hymls_tpu_torch import Solver
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec

    reset_counts()
    t0 = time.perf_counter()
    K, b, S, res, relres, t_init, gathers = drive_main_path(device,
                                                            structured)
    torch.cuda.synchronize()
    launches = dia_matvec.launches
    P = S.precond
    # the generic apply gathers 9 times a level, and twice in each of
    # its two Householder transforms where the level has reflectors;
    # the structured apply never
    per_apply = sum(9 + 4 * p.apply_ot for p in P.plans)
    log(f"{tag} newton_step: sentinel gather launches {gathers['solve']} "
        f"in the solve ({per_apply} an apply on the generic path; "
        f"captures and warm-ups count, replays do not), "
        f"{gathers['factorize']} in the factorization")
    if structured is False:
        if gathers["solve"] <= 0 or gathers["solve"] % per_apply:
            raise RuntimeError(f"the generic apply launched the sentinel "
                               f"gather {gathers['solve']} times, not a "
                               f"positive multiple of {per_apply}")
    elif gathers["solve"]:
        raise RuntimeError(f"the structured apply launched the sentinel "
                           f"gather {gathers['solve']} times, not 0")
    log(f"{tag} path: n={K.shape[0]} nnz={K.nnz} "
        f"bands={len(S.op64.offsets)} coarse n={P.coarse_plan.n}; "
        f"structured program active {P._structured_active} "
        f"({P._structured_reason or 'detected'}); setup {t_init:.2f} s, "
        f"first compute+newton_step "
        f"{time.perf_counter() - t0 - t_init:.2f} s")
    log(f"{tag} newton_step: inner f32 iterations {res.iters} (anchor "
        f"{ANCHOR_INNER}), true f64 relres {relres:.3e}, converged "
        f"{res.converged}; dia_spmv launches {launches}")
    if P._structured_active != (structured is not False):
        raise RuntimeError(f"{tag} path: structured program active is "
                           f"{P._structured_active} "
                           f"({P._structured_reason})")
    x = res.x
    if tuple(x.shape) != (K.shape[0],) or x.dtype != torch.float64 or \
            not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{tag} newton_step returned a malformed "
                           f"solution")
    if not relres <= RELRES_OK:
        raise RuntimeError(f"{tag}: relres {relres:.3e} > {RELRES_OK:g}")
    if abs(res.iters - ANCHOR_INNER) > 2:
        raise RuntimeError(f"{tag}: inner iterations {res.iters} not "
                           f"within 2 of the CPU anchor {ANCHOR_INNER}")
    if launches <= 0:
        raise RuntimeError(f"the {tag} path never launched the dia_spmv "
                           f"kernel")

    S64 = Solver(K, P, cavity64_params(structured), dtype=torch.float64,
                 device=device)
    x64, r64 = S64.apply_inverse(b)
    rel64 = float(np.linalg.norm(K @ x64.cpu().numpy() - b)
                  / np.linalg.norm(b))
    log(f"{tag} f64 GMRES: {r64.iters} iterations (anchor {ANCHOR_F64}), "
        f"true relres {rel64:.3e}")
    if abs(r64.iters - ANCHOR_F64) > 1 or not rel64 <= RELRES_OK:
        raise RuntimeError(f"{tag} f64 GMRES: {r64.iters} iterations, "
                           f"relres {rel64:.3e}")
    return K, b, S, launches, gathers


def device_events(fn):
    """(device events, of which memcpy/memset, device busy us) of one
    call of `fn`, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = n_mem = 0
    busy = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            n_mem += e.name.startswith(("Memcpy", "Memset"))
            busy += e.time_range.elapsed_us()
    return n, n_mem, busy


def time_paths(solvers, b, rounds: int = 3):
    """Phase 7: both applies timed inside one call, interleaved (A, B,
    B, A per round) so that drift in the host's speed falls on both
    alike.  Per path: step times, the structured repack, launches per
    step / apply / inner iteration, host issue and device time per
    V-cycle apply."""
    tags = list(solvers)
    order = tags + tags[::-1]
    v = torch.as_tensor(np.random.default_rng(5).standard_normal(
        b.shape[0]), dtype=torch.float32, device=solvers[tags[0]].device)
    samples = {t: {"compute": [], "newton": [], "issue": [], "event": [],
                   "repack": []} for t in tags}
    iters = {}
    for _ in range(rounds):
        for tag in order:
            S = solvers[tag]
            P = S.precond
            s = samples[tag]
            s["compute"].append(wall_median(S.compute, reps=1)[0])
            if P._structured_active:
                s["repack"].append(wall_median(
                    lambda: P._structured.repack(P.factors.pruned), reps=1)[0])
            t, r = wall_median(
                lambda: S.newton_step(S.op64.vals, S.solver.op.vals, b),
                reps=1)
            s["newton"].append(t)
            iters[tag] = r.iters
            f = P.factors
            P.apply_fn(f, v)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                P.apply_fn(f, v)
            s["issue"].append((time.perf_counter() - t0) / 100)
            torch.cuda.synchronize()
            s["event"].append(event_ms(lambda: P.apply_fn(f, v), reps=5,
                                       inner=10, warmup=1))
    # the profiler runs last: CUPTI, once attached, slows later launches
    out = {}
    for tag in tags:
        S = solvers[tag]
        P = S.precond
        med = {k: statistics.median(x) for k, x in samples[tag].items() if x}
        n_it = max(iters[tag], 1)
        per_iter = (med["newton"] - med["compute"]) / n_it
        n_step, n_mem, busy = device_events(
            lambda: S.newton_step(S.op64.vals, S.solver.op.vals, b))
        f = P.factors
        n_apply, _, apply_busy = device_events(lambda: P.apply_fn(f, v))
        rep = (f", of which the structured repack {med['repack']:.4f} s"
               if "repack" in med else "")
        log(f"{tag} times: compute {med['compute']:.4f} s{rep}; "
            f"newton_step {med['newton']:.4f} s ({iters[tag]} inner "
            f"iterations, {per_iter * 1e3:.3f} ms per inner iteration incl."
            f" the f64 residuals; median of {2 * rounds}, interleaved, wall"
            f" clock)")
        log(f"{tag} launches: {n_step} device events per newton_step "
            f"({n_mem} memcpy/memset), {n_step / n_it:.1f} per inner "
            f"iteration; {n_apply} per V-cycle apply; device busy "
            f"{busy / 1e3:.2f} ms per step (profiled), idle share "
            f"{1 - busy * 1e-6 / med['newton']:.3f} of the unprofiled step")
        log(f"{tag} V-cycle apply: host issue {med['issue'] * 1e6:.1f} us "
            f"per call (100 calls, no sync; median of {2 * rounds}), "
            f"{med['event'] * 1e3:.1f} us per call by CUDA events, "
            f"{apply_busy:.1f} us device busy (profiled)")
        out[tag] = {"compute_s": med["compute"],
                    "repack_s": med.get("repack"),
                    "newton_step_s": med["newton"], "inner": iters[tag],
                    "events_per_step": n_step, "events_per_apply": n_apply,
                    "apply_issue_us": med["issue"] * 1e6,
                    "apply_event_us": med["event"] * 1e3,
                    "apply_device_us": apply_busy,
                    "device_busy_ms": busy / 1e3}
    return out


def coarse_matrix(P):
    """The dense coarse matrix of `P`'s current values, assembled as its
    factorization assembles it (in the factor dtype, every level's
    orthogonal transform as its plan says)."""
    from hymls_tpu_torch.core.preconditioner import (_compute_level,
                                                     _coarse_matrix)
    v = torch.as_tensor(P.K.data, dtype=P.factor_dtype, device=P.device)
    for dp, plan in zip(P.factor_plans, P.plans):
        _, v = _compute_level(v, dp, apply_ot=plan.apply_ot)
    dc = P.extra_plan
    return _coarse_matrix(v, dc["rows"], dc["cols"], dc["diag_entry"],
                          dc["fix_rows"], P.coarse_plan.n)


def coarse_inverse_residual(P):
    """max|I - A X| of the coarse inverse of preconditioner `P`,
    computed in f64."""
    A = coarse_matrix(P)
    X = P.factors.full["coarse"]["inv"]
    eye = torch.eye(A.shape[0], dtype=torch.float64, device=A.device)
    return tuple(A.shape), float((eye - A.double() @ X.double()).abs().max())


def scaled(K, s):
    """K with every value times s (a Newton sequence's next Jacobian)."""
    Ks = K.copy()
    Ks.data = K.data * s
    return Ks


def drive_warm_sequence(device, structured, tag):
    """Phase 8: on cavity64_Re1000, compute() and a cold newton_step,
    then WARM_STEPS newton_step_warm calls threading the factors, step i
    on the values times 1 + 1e-6 (i + 1) (bench.py's warm sequence).
    Each step's true f64 relres against its own scaled K must be
    <= RELRES_OK and its inner iterations within 2 of the JAX package's
    CPU count.  Returns (solver, K, b, K1 launches per warm step)."""
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    from hymls_tpu_torch.stencils import create_testvector

    K, b = cavity64()
    params = cavity64_params(structured)
    S = IterativeRefinementSolver(K, params, testvector=create_testvector(
        params, K), device=device)
    S.compute()
    cold = S.newton_step(S.op64.vals, S.solver.op.vals, b)
    fac = S.precond.factors
    launches = []
    for i, anchor in enumerate(ANCHOR_WARM[tag]):
        s = 1.0 + 1e-6 * (i + 1)
        n0 = dia_matvec.launches
        res, fac = S.newton_step_warm(S.op64.vals * s, S.solver.op.vals * s,
                                      b, fac)
        launches.append(dia_matvec.launches - n0)
        x = res.x.cpu().numpy()
        relres = float(np.linalg.norm(scaled(K, s) @ x - b)
                       / np.linalg.norm(b))
        log(f"{tag} warm step {i}: inner f32 iterations {res.iters} "
            f"(JAX CPU {anchor}; cold step {cold.iters}), true f64 relres "
            f"{relres:.3e}, dia_spmv launches {launches[-1]}")
        if not relres <= RELRES_OK or not np.isfinite(x).all():
            raise RuntimeError(f"{tag} warm step {i}: relres {relres:.3e}")
        if abs(res.iters - anchor) > 2:
            raise RuntimeError(f"{tag} warm step {i}: {res.iters} inner "
                               f"iterations, JAX CPU anchor {anchor}")
    if S.precond._structured_active != (structured is not False):
        raise RuntimeError(f"{tag} warm path on the wrong apply")
    if min(launches) <= 0:
        raise RuntimeError(f"a {tag} warm step never launched dia_spmv")
    return S, K, b, launches


def host_syncs(fn):
    """Synchronizing CUDA calls (scalar reads, error checks) made by one
    call of `fn`, as torch's sync debug mode reports them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def time_warm(solvers, K, b, rounds: int = 5):
    """Phase 8's times, both applies interleaved as in phase 7 (A, B, B,
    A per round): compute() against recompute() (each with the
    structured repack where that apply is active) on values scaled
    anew per call, the repack alone, and newton_step against
    newton_step_warm; then the host syncs of one compute() and one
    recompute(), and the device busy time (torch.profiler) of each of
    the four."""
    tags = list(solvers)
    order = tags + tags[::-1]
    samples = {t: {"compute": [], "recompute": [], "repack": [],
                   "cold_step": [], "warm_step": []} for t in tags}
    facs = {t: solvers[t].precond.factors for t in tags}
    j = 0
    for _ in range(rounds):
        for tag in order:
            S = solvers[tag]
            P = S.precond
            s_ = samples[tag]
            j += 1
            s = 1.0 + 1e-6 * j
            Ks, Ks2 = scaled(K, s), scaled(K, s + 5e-7)
            s_["compute"].append(wall_median(lambda: P.compute(Ks), 1)[0])
            s_["recompute"].append(wall_median(lambda: P.recompute(Ks2),
                                               1)[0])
            if P._structured_active:
                s_["repack"].append(wall_median(
                    lambda: P._structured.repack(P.factors.pruned), 1)[0])
            v64, v32 = S.op64.vals * s, S.solver.op.vals * s
            s_["cold_step"].append(wall_median(
                lambda: S.newton_step(v64, v32, b), 1)[0])
            t, (_, facs[tag]) = wall_median(
                lambda: S.newton_step_warm(v64, v32, b, facs[tag]), 1)
            s_["warm_step"].append(t)
    out = {}
    for tag in tags:
        S = solvers[tag]
        P = S.precond
        med = {k: statistics.median(x) for k, x in samples[tag].items() if x}
        K1, K2 = scaled(K, 1.0 + 1e-6), scaled(K, 1.0 + 2e-6)
        syncs_cold = host_syncs(lambda: P.compute(K1))
        syncs_warm = host_syncs(lambda: P.recompute(K2))
        busy = {"compute": device_events(lambda: P.compute(K1))[2],
                "recompute": device_events(lambda: P.recompute(K2))[2]}
        v64, v32 = S.op64.vals, S.solver.op.vals
        busy["cold_step"] = device_events(
            lambda: S.newton_step(v64, v32, b))[2]
        busy["warm_step"] = device_events(
            lambda: S.newton_step_warm(v64, v32, b, P.factors))[2]
        rep = (f" (each with the repack, alone {med['repack']:.4f} s)"
               if "repack" in med else "")
        log(f"{tag} warm times: compute {med['compute']:.4f} s, recompute "
            f"{med['recompute']:.4f} s{rep}; newton_step "
            f"{med['cold_step']:.4f} s, newton_step_warm "
            f"{med['warm_step']:.4f} s (median of {2 * rounds}, "
            f"interleaved, wall clock); host syncs: {syncs_cold} per "
            f"compute, {syncs_warm} per recompute; device busy (profiled) "
            f"compute {busy['compute'] / 1e3:.2f} / recompute "
            f"{busy['recompute'] / 1e3:.2f} ms, newton_step "
            f"{busy['cold_step'] / 1e3:.2f} / newton_step_warm "
            f"{busy['warm_step'] / 1e3:.2f} ms")
        out[tag] = {**{f"{k}_s": v for k, v in med.items()},
                    **{f"{k}_device_busy_ms": v / 1e3
                       for k, v in busy.items()},
                    "host_syncs_compute": syncs_cold,
                    "host_syncs_recompute": syncs_warm}
    return out


def cavity64_bordered_params():
    """bench.py's cavity64 parameters with the reference cavity setup's
    constant-pressure border (tests/test_bordered.py:48-83): 'Fix
    Pressure Level' off, 'Null Space Type' 'Constant P'."""
    params = cavity64_params("Auto")
    params.sublist("Preconditioner")["Fix Pressure Level"] = False
    params.sublist("Driver")["Null Space Type"] = "Constant P"
    return params


def drive_bordered(device):
    """Phase 9: the bordered f64 GMRES solve on cavity64_Re1000 with the
    constant-pressure border; x_ex from default_rng(7) projected off the
    border, b = K x_ex.  Returns the checks' numbers and a function that
    computes and solves again (for timing)."""
    from hymls_tpu_torch import Preconditioner, Solver
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.stencils import create_nullspace, create_testvector
    from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian

    K = cavity_jacobian(64, 64, re=1000.0).tocsr()
    params = cavity64_bordered_params()
    ns = create_nullspace(params, K.shape[0])
    x_ex = np.random.default_rng(7).standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    b = K @ x_ex
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=device)
    S = Solver(K, P, params, device=device)
    S.set_border(ns)
    if P._structured is None or P._structured_active:
        raise RuntimeError(f"bordered: structured program built "
                           f"{P._structured is not None}, active "
                           f"{P._structured_active}; want built, inactive")
    t0 = time.perf_counter()
    P.compute()
    x, res = S.apply_inverse(b)
    x = x.cpu().numpy()
    t = time.perf_counter() - t0
    launches = dia_matvec.launches
    relres = float(np.linalg.norm(K @ x - b) / np.linalg.norm(b))
    coeff = float(np.abs(S._border_coeffs).max())
    log(f"bordered f64 GMRES: {res.iters} iterations (JAX CPU "
        f"{ANCHOR_BORDERED}), true relres {relres:.3e}, |border coeffs| "
        f"{coeff:.3e}, structured program inactive; compute + solve "
        f"{t:.4f} s (first call); dia_spmv launches {launches}")
    if not relres <= RELRES_OK or abs(res.iters - ANCHOR_BORDERED) > 1 \
            or not coeff <= 1e-8 or not np.isfinite(x).all():
        raise RuntimeError(f"bordered: {res.iters} iterations, relres "
                           f"{relres:.3e}, |border coeffs| {coeff:.3e}")
    if launches <= 0:
        raise RuntimeError("the bordered path never launched dia_spmv")

    def again():
        P.compute()
        return S.apply_inverse(b)[0]
    return {"iters": res.iters, "relres": relres, "border_coeff": coeff,
            "launches": launches, "first_s": t}, again


def bratu(nx):
    """tests/test_nonlinear.py:_bratu: -lap(u) = lam exp(u) on nx^2,
    residual, Jacobian and dF/dlam on the host."""
    import scipy.sparse as sp
    from hymls_tpu_torch.stencils import laplace2d
    L = -laplace2d(nx, nx)
    h2 = 1.0 / (nx + 1) ** 2

    def residual(x, lam):
        return L @ x - lam * h2 * np.exp(x)

    def jacobian(x, lam):
        J = (L - sp.diags(lam * h2 * np.exp(x))).tocsr()
        J.sum_duplicates()
        J.sort_indices()
        return J

    def dres_dlam(x, lam):
        return -h2 * np.exp(x)

    return residual, jacobian, dres_dlam


def bratu_params(nx):
    """tests/test_nonlinear.py:_params."""
    from hymls_tpu_torch import Params
    return Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2, "nx": nx,
                    "ny": nx},
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": 100,
                                        "Convergence Tolerance": 1e-12}},
        "Preconditioner": {"Separator Length": 4, "Number of Levels": 1}})


def drive_continuation(device):
    """Phase 10: NewtonSolver to lam = 0.5 on Bratu 64^2, then
    Continuation.trace through the fold (ds, steps = BRATU_DS,
    BRATU_STEPS), held to tests/test_nonlinear.py's criteria and to the
    JAX package's CPU trace.  Returns the checks' numbers."""
    from hymls_tpu_torch.nonlinear import Continuation, NewtonSolver
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec

    nx = 64
    residual, jacobian, dres_dlam = bratu(nx)
    params = bratu_params(nx)
    t0 = time.perf_counter()
    start = NewtonSolver(lambda x: residual(x, 0.5),
                         lambda x: jacobian(x, 0.5), params,
                         device=device).solve(np.zeros(nx * nx))
    t_newton = time.perf_counter() - t0
    newton_launches = dia_matvec.launches
    if not start.converged:
        raise RuntimeError("Bratu Newton solve did not converge")
    t0 = time.perf_counter()
    branch = Continuation(residual, jacobian, dres_dlam, params,
                          device=device).trace(start.x, 0.5, ds=BRATU_DS,
                                               n_steps=BRATU_STEPS)
    t_trace = time.perf_counter() - t0
    launches = dia_matvec.launches - newton_launches
    lams = [p.lam for p in branch]
    iters = [p.newton_iters for p in branch[1:]]
    # bordered solves: the initial tangent, then it - 1 per point (the
    # it-th pass only finds the corrector converged)
    solves = 1 + sum(it - 1 for it in iters)
    lam_max, lam_last = float(max(lams)), float(lams[-1])
    log(f"Bratu {nx}^2: Newton to lam 0.5 in {start.iterations} "
        f"iterations, {t_newton:.3f} s, dia_spmv launches "
        f"{newton_launches}")
    log(f"continuation: {len(branch) - 1} steps of ds {BRATU_DS}, Newton "
        f"iterations {iters}; max lam {lam_max!r} (JAX CPU "
        f"{ANCHOR_LAM_MAX!r}), last lam {lam_last!r} (JAX CPU "
        f"{ANCHOR_LAM_LAST!r}); {solves} correctors in {t_trace:.3f} s, "
        f"{t_trace / solves * 1e3:.2f} ms and "
        f"{launches / solves:.1f} dia_spmv launches per corrector")
    if not (lam_max > 6.0 and lam_last < lam_max - 0.3
            and all(it < 12 for it in iters)):
        raise RuntimeError(f"continuation did not pass the fold: {lams}")
    if abs(lam_max - ANCHOR_LAM_MAX) > 1e-6 or \
            abs(lam_last - ANCHOR_LAM_LAST) > 1e-6:
        raise RuntimeError(f"continuation: max lam {lam_max!r}, last "
                           f"{lam_last!r}, off the JAX CPU trace")
    if launches <= 0 or newton_launches <= 0:
        raise RuntimeError("the continuation path never launched dia_spmv")
    return {"newton_launches": newton_launches, "launches": launches,
            "correctors": solves, "lam_max": lam_max, "lam_last": lam_last,
            "newton_s": t_newton, "trace_s": t_trace,
            "ms_per_corrector": t_trace / solves * 1e3,
            "launches_per_corrector": launches / solves}


def true_relres(K, x, b) -> float:
    return float(np.linalg.norm(K @ x.cpu().numpy() - b) / np.linalg.norm(b))


def stokes_params(nx, dim, levels, partitioner, maxiter=250, tol=1e-12):
    """bench.py:_stokes_params."""
    from hymls_tpu_torch import Params
    prob = {"Equations": "Stokes-C", "Dimension": dim, "nx": nx, "ny": nx}
    if dim == 3:
        prob["nz"] = nx
    return Params({
        "Problem": prob,
        "Solver": {"Krylov Method": "GMRES",
                   "Left or Right Preconditioning": "Right",
                   "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": maxiter,
                                        "Convergence Tolerance": tol}},
        "Preconditioner": {"Partitioner": partitioner,
                           "Separator Length": 4,
                           "Number of Levels": levels}})


def stokesB64_case():
    """bench.py's stokesB_64: configs/stokes_B.xml at 64^2."""
    from hymls_tpu_torch.config import load_xml
    from hymls_tpu_torch.stencils import create_matrix
    pb = load_xml(os.path.join(HERE, "configs", "stokes_B.xml"))
    pb.sublist("Problem")["nx"] = 64
    pb.sublist("Problem")["ny"] = 64
    it = pb.sublist("Solver").sublist("Iterative Solver")
    it["Maximum Iterations"] = 250
    it["Convergence Tolerance"] = 1e-12
    K = create_matrix(pb).tocsr()
    return pb, K, K @ np.random.default_rng(3).standard_normal(K.shape[0])


def stokes128_case():
    """bench.py's stokes128_L2."""
    from hymls_tpu_torch.stencils import create_matrix
    p = stokes_params(128, 2, 2, "Cartesian")
    K = create_matrix(p).tocsr()
    return p, K, K @ np.random.default_rng(1).standard_normal(K.shape[0])


def stokes32cube_case():
    """bench.py's stokes32cube_skew_L2."""
    from hymls_tpu_torch.stencils import create_matrix
    p = stokes_params(32, 3, 2, "Skew Cartesian", maxiter=500, tol=1e-8)
    p.sublist("Solver").sublist("Iterative Solver")["Num Blocks"] = 60
    K = create_matrix(p).tocsr()
    return p, K, K @ np.random.default_rng(2).standard_normal(K.shape[0])


def drive_newton_case(device, tag, case, anchor, relres_ok=RELRES_OK,
                      structured=None, reason=None, max_inner=None,
                      slack=2, timed_steps=2):
    """Phases 11, 12, 16, 17: IterativeRefinementSolver on `case`
    (params, K, b) on the card, compute() then newton_step(), with the
    launch counts set to 0 just before; true f64 relres <= `relres_ok`,
    inner f32 iterations within `slack` of `anchor` (and at most
    `max_inner`),
    the structured program active or not as `structured` says (with
    `reason` where it is not).  Returns (solver, numbers)."""
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    from hymls_tpu_torch.stencils import create_testvector

    params, K, b = case
    tv = create_testvector(params, K)
    reset_counts()
    t0 = time.perf_counter()
    S = IterativeRefinementSolver(K, params, testvector=tv, device=device)
    t_setup = time.perf_counter() - t0
    t_compute, _ = wall_median(S.compute, 1)
    t_first, res = wall_median(
        lambda: S.newton_step(S.op64.vals, S.solver.op.vals, b), 1)
    launches = dia_matvec.launches
    P = S.precond
    relres = true_relres(K, res.x, b)
    t_step = wall_median(
        lambda: S.newton_step(S.op64.vals, S.solver.op.vals, b),
        timed_steps)[0] if timed_steps else t_first
    log(f"{tag}: n={K.shape[0]} nnz={K.nnz} bands={len(S.op64.offsets)} "
        f"levels={P.max_level} coarse n={P.coarse_plan.n}; structured "
        f"program active {P._structured_active} "
        f"({P._structured_reason or 'detected'}); setup {t_setup:.2f} s, "
        f"first compute {t_compute:.4f} s, first newton_step "
        f"{t_first:.4f} s, then {t_step:.4f} s")
    log(f"{tag} newton_step: inner f32 iterations {res.iters} (JAX CPU "
        f"{anchor}), true f64 relres {relres:.3e}, converged "
        f"{res.converged}; dia_spmv launches {launches}")
    x = res.x
    if tuple(x.shape) != (K.shape[0],) or x.dtype != torch.float64 or \
            not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{tag}: malformed solution")
    if structured is not None and P._structured_active != structured:
        raise RuntimeError(f"{tag}: structured program active is "
                           f"{P._structured_active} "
                           f"({P._structured_reason})")
    if reason is not None and P._structured_reason != reason:
        raise RuntimeError(f"{tag}: generic apply because "
                           f"{P._structured_reason!r}, expected {reason!r}")
    if not relres <= relres_ok:
        raise RuntimeError(f"{tag}: relres {relres:.3e} > {relres_ok:g}")
    if abs(res.iters - anchor) > slack or \
            (max_inner is not None and res.iters > max_inner):
        raise RuntimeError(f"{tag}: {res.iters} inner iterations, JAX CPU "
                           f"anchor {anchor}")
    if launches <= 0:
        raise RuntimeError(f"the {tag} path never launched dia_spmv")
    return S, {"n": K.shape[0], "inner": res.iters, "relres": relres,
               "launches": launches, "setup_s": t_setup,
               "first_compute_s": t_compute, "newton_step_s": t_step,
               "structured": P._structured_active}


def drive_restart(device):
    """Phase 13: f64 GMRES on cavity64 restarted every 30 iterations,
    then the IR solver with 'Num Blocks' 60."""
    from hymls_tpu_torch import Preconditioner, Solver
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.stencils import create_testvector

    K, b = cavity64()
    params = cavity64_params("Auto")
    params.sublist("Solver").sublist("Iterative Solver")["Num Blocks"] = 30
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=device).compute()
    S = Solver(K, P, params, device=device)
    reset_counts()
    t, (x, res) = wall_median(lambda: S.apply_inverse(b), 1)
    launches = dia_matvec.launches
    relres = true_relres(K, x, b)
    log(f"restarted f64 GMRES ('Num Blocks' 30): {res.iters} iterations "
        f"(JAX CPU {ANCHOR_RESTART30}, unrestarted {ANCHOR_F64}), true "
        f"relres {relres:.3e}, converged {res.converged}, {t:.4f} s; "
        f"dia_spmv launches {launches}")
    if not res.converged or not relres <= RELRES_OK or \
            abs(res.iters - ANCHOR_RESTART30) > 1:
        raise RuntimeError(f"restarted GMRES: {res.iters} iterations, "
                           f"relres {relres:.3e}")
    if launches <= 0:
        raise RuntimeError("the restarted path never launched dia_spmv")

    p60 = cavity64_params("Auto")
    p60.sublist("Solver").sublist("Iterative Solver")["Num Blocks"] = 60
    _, ir = drive_newton_case(device, "IR solver with 'Num Blocks' 60",
                              (p60, K, b), ANCHOR_INNER, structured=True,
                              timed_steps=0)
    return {"iters": res.iters, "relres": relres, "launches": launches,
            "solve_s": t, "ir_numblocks60": ir}


def drive_direct(device):
    """Phase 14: 'Number of Levels' 0 on cavity64 in f64, plain and with
    the constant-pressure border; the dense factorization timed inside
    one compute()."""
    import hymls_tpu_torch.core.dense as dense
    import hymls_tpu_torch.core.preconditioner as pc
    from hymls_tpu_torch import Preconditioner, Solver
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.stencils import create_nullspace, create_testvector

    K, b = cavity64()
    out = {}
    for tag in ("plain", "bordered"):
        params = cavity64_params("Auto") if tag == "plain" \
            else cavity64_bordered_params()
        params.sublist("Preconditioner")["Number of Levels"] = 0
        P = Preconditioner(K, params, testvector=create_testvector(params, K),
                           device=device)
        S = Solver(K, P, params, device=device)
        rhs = b
        if tag == "bordered":
            ns = create_nullspace(params, K.shape[0])
            x_ex = np.random.default_rng(7).standard_normal(K.shape[0])
            x_ex -= ns @ (ns.T @ x_ex)
            rhs = K @ x_ex
            S.set_border(ns)
        dense_s = []
        orig = dense.dense_factor

        def timed(A):
            t, fac = wall_median(lambda: orig(A), 1)
            dense_s.append((tuple(A.shape), t))
            return fac
        # the bordered factor calls it by the preconditioner's name, the
        # plain one through `dense.dense_refactor`
        pc._dense_factor = dense.dense_factor = timed
        try:
            t_compute, _ = wall_median(P.compute, 1)
        finally:
            pc._dense_factor = dense.dense_factor = orig
        t_again, _ = wall_median(P.compute, 3)
        if tag == "bordered":
            y = P.apply_inverse_bordered(rhs, np.zeros(ns.shape[1]))[0]
        else:
            y = P.apply_inverse(rhs)
        one = true_relres(K, y, rhs)
        reset_counts()
        x, res = S.apply_inverse(rhs)
        launches = dia_matvec.launches
        relres = true_relres(K, x, rhs)
        (shape, t_dense), = dense_s
        log(f"direct Schur {tag}: n_sep={P.plans[0].n_sep}, dense factor of "
            f"{list(shape)} ({'/'.join(P.factors.full['coarse'])}) "
            f"{t_dense:.4f} s of the first compute's {t_compute:.4f} s, "
            f"compute then {t_again:.4f} s (median of 3); one apply leaves "
            f"relres {one:.3e}; f64 GMRES {res.iters} iterations (JAX CPU "
            f"{ANCHOR_DIRECT[tag]}), true relres {relres:.3e}; dia_spmv "
            f"launches {launches}; {P._structured_reason}")
        one_ok = 1e-10 if tag == "bordered" else 1e-5
        if not one <= one_ok or not res.converged or res.iters > 2 or \
                res.iters != ANCHOR_DIRECT[tag] or not relres <= 1e-10:
            raise RuntimeError(f"direct Schur {tag}: one apply {one:.3e}, "
                               f"{res.iters} iterations, relres "
                               f"{relres:.3e}")
        if P._structured_reason != "direct-SC mode" or launches <= 0:
            raise RuntimeError(f"direct Schur {tag}: "
                               f"{P._structured_reason}, {launches} launches")
        out[tag] = {"n_sep": P.plans[0].n_sep, "dense_factor_s": t_dense,
                    "compute_s": t_again, "one_apply_relres": one,
                    "iters": res.iters, "relres": relres,
                    "launches": launches}
    return out


def stokes_l2_params(nx, bgrid, dropping=True):
    """configs/stokes_L2.xml on nx^3 (column subdomains: the separator
    length in z is nx), with or without its B-grid transform."""
    from hymls_tpu_torch.config import load_xml
    p = load_xml(os.path.join(HERE, "configs", "stokes_L2.xml"))
    for k in ("nx", "ny", "nz"):
        p.sublist("Problem")[k] = nx
    prec = p.sublist("Preconditioner")
    prec["Separator Length (z)"] = nx
    prec["B-Grid Transform"] = bgrid
    if not dropping:
        prec["Apply Dropping"] = False
    return p


def drive_bgrid(device):
    """Phase 15: stokes_L2 at 8^3 with and without the B-grid transform,
    then its no-dropping variant at 16^3 with the transform."""
    from hymls_tpu_torch import Params, Preconditioner, Solver
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.stencils import (create_matrix, create_nullspace,
                                          create_testvector)

    def solve(nx, bgrid, dropping, anchor, max_iters):
        params = stokes_l2_params(nx, bgrid, dropping)
        K = create_matrix(params).tocsr()
        ns = create_nullspace(Params(
            {"Problem": params.sublist("Problem").to_dict(),
             "Driver": {"Null Space Type": "Checkerboard"}}), K.shape[0])
        x_ex = np.random.default_rng(7).standard_normal(K.shape[0])
        x_ex -= ns @ (np.linalg.pinv(ns) @ x_ex)
        b = K @ x_ex
        t0 = time.perf_counter()
        P = Preconditioner(K, params, device=device,
                           testvector=create_testvector(params, K))
        t_setup = time.perf_counter() - t0
        P.compute()
        v = torch.as_tensor(b, device=device)
        reset_counts()
        # one eager apply: the first apply_fn also warms up and captures,
        # and a replay runs the captured launches without counting them
        P._apply_eager(P.factors, v)
        per_apply = dia_matvec.launches
        S = Solver(K, P, params, device=device)
        reset_counts()
        t, (x, res) = wall_median(lambda: S.apply_inverse(b), 1)
        launches = dia_matvec.launches
        relres = true_relres(K, x, b)
        tag = (f"stokes_L2 {nx}^3 {'with' if bgrid else 'without'} the "
               f"B-grid transform{'' if dropping else ', no dropping'}")
        log(f"{tag}: n={K.shape[0]}, structured program active "
            f"{P._structured_active} ({P._structured_reason or 'detected'}),"
            f" setup {t_setup:.2f} s; {res.iters} iterations (JAX CPU "
            f"{anchor}), true relres {relres:.3e}, solve {t:.4f} s; "
            f"dia_spmv launches {per_apply} per preconditioner apply, "
            f"{launches} per solve")
        if not res.converged or res.iters > max_iters or \
                abs(res.iters - anchor) > 1 or not relres < 1e-9:
            raise RuntimeError(f"{tag}: {res.iters} iterations, relres "
                               f"{relres:.3e}")
        if P._structured_active != dropping or launches <= 0:
            raise RuntimeError(f"{tag}: structured program active "
                               f"{P._structured_active}, {launches} "
                               f"launches")
        return {"n": K.shape[0], "iters": res.iters, "relres": relres,
                "launches_per_apply": per_apply, "launches": launches,
                "solve_s": t, "setup_s": t_setup}

    out = {"8_bgrid": solve(8, True, True, ANCHOR_BGRID[True], 80),
           "8_plain": solve(8, False, True, ANCHOR_BGRID[False], 80),
           "16_bgrid_nodrop": solve(16, True, False, ANCHOR_BGRID_NODROP16,
                                    80)}
    extra = out["8_bgrid"]["launches_per_apply"] - \
        out["8_plain"]["launches_per_apply"]
    if extra != 2 or out["16_bgrid_nodrop"]["launches_per_apply"] != 2:
        raise RuntimeError(f"the B-grid transform adds {extra} dia_spmv "
                           f"launches per apply, expected 2")
    return out


def drive_factor_precision(device, same):
    """Phase 16: cavity64's Newton step with 'Factor Precision' 'f64',
    'Schur Assembly' 'Full f64' and 'Vsum f64'; then compute() of both
    and of `same` (phase 5's solver, the all-f32 chain), interleaved."""
    K, b = cavity64()
    solvers, out = {"Same": same}, {}
    for mode in ("Full f64", "Vsum f64"):
        params = cavity64_params("Auto")
        prec = params.sublist("Preconditioner")
        prec["Factor Precision"] = "f64"
        prec["Schur Assembly"] = mode
        S, out[mode] = drive_newton_case(
            device, f"'Factor Precision' f64, {mode}", (params, K, b),
            ANCHOR_FACTOR64, structured=True, timed_steps=0)
        P = S.precond
        a11inv = P.factors.full["levels"][0]["A11inv"]
        if P.factor_dtype != torch.float64 or \
                a11inv.dtype != torch.float32 or \
                ("vsum_col" in P.factor_plans[0]) != (mode == "Vsum f64"):
            raise RuntimeError(f"{mode}: not the upcast chain it names")
        solvers[mode] = S
    tags = list(solvers)
    samples = {t: [] for t in tags}
    for _ in range(3):
        for tag in tags + tags[::-1]:
            samples[tag].append(wall_median(solvers[tag].compute, 1)[0])
    med = {t: statistics.median(x) for t, x in samples.items()}
    log("compute() with the structured repack, median of 6, interleaved: "
        + ", ".join(f"{t} {med[t]:.4f} s" for t in tags))
    for t in tags:
        out.setdefault(t, {})["compute_s"] = med[t]
    return out


def drive_stokes32cube(device):
    """Phase 17: bench.py's stokes32cube_skew_L2: the Newton step with
    bench.py's checks, then the f64 GMRES solve restarted every 60."""
    from hymls_tpu_torch import Solver
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec

    case = stokes32cube_case()
    S, out = drive_newton_case(device, "stokes32cube_skew_L2", case,
                               ANCHOR_STOKES32, relres_ok=1e-7,
                               structured=False, max_inner=500,
                               slack=STOKES32_BAND * ANCHOR_STOKES32,
                               timed_steps=1)
    params, K, b = case
    S64 = Solver(K, S.precond, params, dtype=torch.float64, device=device)
    reset_counts()
    t, (x, res) = wall_median(lambda: S64.apply_inverse(b), 1)
    relres = true_relres(K, x, b)
    log(f"stokes32cube_skew_L2 f64 GMRES ('Num Blocks' 60): {res.iters} "
        f"iterations (JAX CPU {ANCHOR_STOKES32_F64}), true relres "
        f"{relres:.3e}, {t:.4f} s; dia_spmv launches {dia_matvec.launches}")
    if not res.converged or res.iters > 500 or not relres <= 1e-7 or \
            abs(res.iters - ANCHOR_STOKES32_F64) > \
            STOKES32_BAND * ANCHOR_STOKES32_F64 or \
            dia_matvec.launches <= 0:
        raise RuntimeError(f"stokes32cube f64 GMRES: {res.iters} "
                           f"iterations, relres {relres:.3e}")
    out.update(f64_iters=res.iters, f64_relres=relres, f64_solve_s=t,
               f64_launches=dia_matvec.launches,
               plan_s=S.precond.plan_seconds,
               plan_from_cache=S.precond.plan_from_cache)
    return out


def laplace_params(nx, levels, solver=None, drv=None, maxiter=300,
                   tol=1e-10):
    """tests/test_variants.py:_params and tests/test_combos.py:
    _neumann_setup: Laplace nx^2, separator length 4, GMRES from a zero
    start vector; `solver` adds to the 'Solver' list, `drv` is the
    'Driver' list."""
    from hymls_tpu_torch import Params
    return Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2, "nx": nx,
                    "ny": nx},
        "Driver": dict(drv or {}),
        "Solver": {"Krylov Method": "GMRES", "Initial Vector": "Zero",
                   "Iterative Solver": {"Maximum Iterations": maxiter,
                                        "Convergence Tolerance": tol},
                   **(solver or {})},
        "Preconditioner": {"Separator Length": 4,
                           "Number of Levels": levels}})


def drive_deflated(device, tag, K, b, params_of, anchor, anchor_plain, k,
                   border=None, x_ex=None):
    """Phases 18-19: the solve of K x = b without deflation, then with
    `k` deflated modes (`params_of(k)` gives the parameters), with the
    border `border` on both.  The launch counts are set to 0 just before
    the deflated path (`setup_deflation` and one solve).  Checks: true
    relres <= 5e-9 (and the error against `x_ex`, where given), the
    projected solve's iterations within 2 of the JAX package's CPU count
    and no more than without deflation, the subspace iteration converged
    (rel <= 1e-5) before its 60-iteration cap, V'V = I to 1e-10.
    Returns the numbers."""
    from hymls_tpu_torch import Preconditioner, Solver
    from hymls_tpu_torch.ops.dia_spmv import dia_matmat, dia_matvec
    from hymls_tpu_torch.stencils import create_testvector

    def make(kk):
        params = params_of(kk)
        P = Preconditioner(K, params, device=device,
                           testvector=create_testvector(params, K))
        S = Solver(K, P, params, device=device)
        if border is not None:
            S.set_border(border)
        P.compute()
        return S

    S0 = make(0)
    t_plain, (x0, r0) = wall_median(lambda: S0.apply_inverse(b), 1)
    S = make(k)
    reset_counts()
    with deflation_setups() as setups:
        S.setup_deflation()
    rec = setups[0]
    setup_launches = dia_matvec.launches
    t_solve, (x, res) = wall_median(lambda: S.apply_inverse(b), 1)
    launches = dia_matvec.launches
    matmat_launches = dia_matmat.launches
    info, V = S._defl_info, S._deflation.V
    kp = k + 6
    relres = true_relres(K, x, b)
    ortho = float(np.abs(V.T @ V - np.eye(k)).max())
    err = None if x_ex is None else float(
        np.linalg.norm(x.cpu().numpy() - x_ex) / np.linalg.norm(x_ex))
    log(f"{tag}: n={K.shape[0]}, k={k}, kp={kp}; {setup_line(rec)}; "
        f"max|V'V - I| {ortho:.1e}")
    log(f"{tag} solve: {res.iters} iterations (JAX CPU {anchor}; without "
        f"deflation {r0.iters}, JAX CPU {anchor_plain}, {t_plain:.4f} s), "
        f"true relres {relres:.3e}"
        f"{'' if err is None else f', error {err:.3e}'}, {t_solve:.4f} s, "
        f"{t_solve / max(res.iters, 1) * 1e3:.3f} ms per iteration; "
        f"dia_spmv launches {launches - setup_launches}, dia_matmat "
        f"{matmat_launches - rec['matmat_launches']}")
    if tuple(x.shape) != (K.shape[0],) or not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{tag}: malformed solution")
    if not relres <= 5e-9 or (err is not None and not err <= 5e-9):
        raise RuntimeError(f"{tag}: relres {relres:.3e}, error {err}")
    if abs(res.iters - anchor) > 2 or res.iters > r0.iters or \
            abs(r0.iters - anchor_plain) > 2:
        raise RuntimeError(f"{tag}: {res.iters} iterations deflated, "
                           f"{r0.iters} plain; JAX CPU {anchor}, "
                           f"{anchor_plain}")
    if not info["rel"] <= 1e-5 or not info["applies"] < 61 * kp or \
            not ortho <= 1e-10:
        raise RuntimeError(f"{tag}: subspace iteration {info}, "
                           f"max|V'V - I| {ortho:.1e}")
    if rec["matmat_launches"] <= 0:
        raise RuntimeError(f"the {tag} setup never launched dia_matmat")
    if launches <= setup_launches:
        raise RuntimeError(f"the {tag} solve never launched dia_spmv")
    return {"n": K.shape[0], "k": k, "iters": res.iters,
            "iters_plain": r0.iters, "relres": relres, "error": err,
            "applies": info["applies"], "block_applies":
            info["applies"] // kp, "rel": info["rel"],
            "setup_s": rec["setup_s"], "subspace_s": rec["subspace_s"],
            "projected_solves_s": rec["projected_solves_s"],
            "gmres_iters": rec["gmres_iters"], "solve_s": t_solve,
            "plain_solve_s": t_plain,
            "setup_launches": setup_launches,
            "setup_matmat_launches": rec["matmat_launches"],
            "solve_launches": launches - setup_launches,
            "launches": launches, "matmat_launches": matmat_launches}


def drive_deflated_aniso(device):
    """Phase 18: tests/test_variants.py's anisotropic Laplace at
    128^2."""
    from hymls_tpu_torch.stencils.generators import _cross2d
    nx, eps = DEFL_NX, 0.01
    K = (-_cross2d(nx, nx, 2 + 2 * eps, -1.0, -1.0, -eps, -eps)).tocsr()
    b = K @ np.random.default_rng(5).standard_normal(K.shape[0])
    return drive_deflated(
        device, "deflated", K, b,
        lambda k: laplace_params(
            nx, 2, solver={"Deflated Subspace Dimension": k}),
        ANCHOR_DEFLATED, ANCHOR_DEFLATED_PLAIN, 8)


def neumann_case(nx, levels, solver=None):
    """tests/test_combos.py:_neumann_setup: (params, K, null space)."""
    from hymls_tpu_torch.stencils import create_nullspace, laplace2d_neumann
    params = laplace_params(nx, levels, solver=solver,
                            drv={"Null Space Type": "Constant"})
    K = laplace2d_neumann(nx, nx).tocsr()
    return params, K, create_nullspace(params, K.shape[0])


def drive_bordered_deflated(device):
    """Phase 19: tests/test_combos.py::test_bordered_deflated at 128^2."""
    nx = DEFL_NX
    _, K, ns = neumann_case(nx, 2)
    x_ex = np.random.default_rng(3).standard_normal(K.shape[0])
    x_ex -= ns @ (ns.T @ x_ex)
    return drive_deflated(
        device, "bordered + deflated", K, K @ x_ex,
        lambda k: neumann_case(
            nx, 2, solver={"Deflated Subspace Dimension": k})[0],
        ANCHOR_BORDERED_DEFLATED, ANCHOR_BORDERED_DEFLATED_PLAIN, 6,
        border=ns, x_ex=x_ex)


def crandn(rng, n):
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def drive_complex(device):
    """Phase 20: (A + 0.5 i I) z = b on the Laplace operator at 128^2
    (tests/test_variants.py::test_complex_solver) beside the real f64
    solve of the same A, and the complex bordered solve of
    tests/test_combos.py::test_complex_bordered at 128^2."""
    import scipy.sparse as sp
    from hymls_tpu_torch import Preconditioner, Solver
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.solvers.complex_solver import ComplexSolver
    from hymls_tpu_torch.stencils import create_testvector, laplace2d

    nx = DEFL_NX
    A = laplace2d(nx, nx).tocsr()
    n = A.shape[0]
    B = sp.identity(n, format="csr") * 0.5
    params = laplace_params(nx, 1)
    P = Preconditioner(A, params, testvector=create_testvector(params, A),
                       device=device).compute()
    z_ex = crandn(np.random.default_rng(11), n)
    b = A @ z_ex + 1j * (B @ z_ex)
    CS = ComplexSolver(A, P, params, B=B, device=device)
    reset_counts()
    CS.apply_inverse(b)                      # warm-up of the libraries
    t, (z, res) = wall_median(lambda: CS.apply_inverse(b), 1)
    launches = dia_matvec.launches
    err = float(np.linalg.norm(z.cpu().numpy() - z_ex)
                / np.linalg.norm(z_ex))
    S = Solver(A, P, params, device=device)
    S.apply_inverse(b.real)
    t_real, (_, r_real) = wall_median(lambda: S.apply_inverse(b.real), 1)
    reset_counts()            # the real solves' DIA launches are not its
    log(f"complex solve (A + 0.5 i I) z = b, n={n}, complex128: "
        f"{res.iters} iterations (JAX CPU {ANCHOR_COMPLEX}), converged "
        f"{res.converged}, error {err:.3e}; {t:.4f} s, "
        f"{t / max(res.iters, 1) * 1e3:.3f} ms per iteration; the real "
        f"f64 solve of A x = Re b: {r_real.iters} iterations, "
        f"{t_real:.4f} s, {t_real / max(r_real.iters, 1) * 1e3:.3f} ms per"
        f" iteration; dia_spmv launches of the complex solves {launches} "
        f"(A and B are ELL operators)")
    if z.dtype != torch.complex128 or tuple(z.shape) != (n,) or \
            not res.converged or not err <= 1e-8 or \
            abs(res.iters - ANCHOR_COMPLEX) > 1:
        raise RuntimeError(f"complex solve: {res.iters} iterations, "
                           f"converged {res.converged}, error {err:.3e}")
    out = {"n": n, "iters": res.iters, "error": err, "solve_s": t,
           "real_iters": r_real.iters, "real_solve_s": t_real}

    params, K, ns = neumann_case(nx, 1)
    B = sp.identity(n, format="csr") * 0.3
    P = Preconditioner(K, params, testvector=create_testvector(params, K),
                       device=device)
    CS = ComplexSolver(K, P, params, B=B, device=device)
    CS.set_border(ns)
    z_ex = crandn(np.random.default_rng(5), n)
    z_ex -= ns @ (ns.T.conj() @ z_ex)
    b = K @ z_ex + 1j * (B @ z_ex)
    CS.apply_inverse(b)
    t, (z, res) = wall_median(lambda: CS.apply_inverse(b), 1)
    z = z.cpu().numpy()
    relres = float(np.linalg.norm(K @ z + 1j * (B @ z) - b)
                   / np.linalg.norm(b))
    log(f"complex bordered solve (Neumann Laplace + 0.3 i I, constant "
        f"border): {res.iters} iterations (JAX CPU "
        f"{ANCHOR_COMPLEX_BORDERED}), converged {res.converged}, true "
        f"relres {relres:.3e}; {t:.4f} s, "
        f"{t / max(res.iters, 1) * 1e3:.3f} ms per iteration")
    if not res.converged or not relres <= 1e-8 or \
            abs(res.iters - ANCHOR_COMPLEX_BORDERED) > 1:
        raise RuntimeError(f"complex bordered solve: {res.iters} "
                           f"iterations, relres {relres:.3e}")
    out.update(bordered_iters=res.iters, bordered_relres=relres,
               bordered_solve_s=t, launches=launches + dia_matvec.launches)
    return out


def eig_params(nx, equations="Laplace", **eig):
    """tests/test_eigen.py:_setup (configs/laplace1_eigs.xml's
    'Eigenvalues' list: 10 smallest, 1e-8, subspace 40 / 20)."""
    params = laplace_params(nx, 1, maxiter=100, drv={"Eigenvalues": {
        "How Many": 10, "Which": "SM", "Convergence Tolerance": 1e-8,
        "Number of Iterations": 100, "Maximum Subspace Dimension": 40,
        "Restart Dimension": 20, **eig}})
    params.sublist("Problem")["Equations"] = equations
    return params


def eig_residuals(K, r):
    return max(float(np.linalg.norm(K @ r.vectors[:, j] -
                                    r.values[j] * r.vectors[:, j]))
               for j in range(r.converged))


def drive_eigen(device):
    """Phase 21: (a) JDQR on configs/laplace1_eigs.xml's problem at its
    refined size 64^2; (b) JDQR on the cavity Jacobian at Re 1000, at
    16^2 and at cavity64's own 64^2, whose four values nearest 0 hold a
    conjugate pair (the complex correction solver); (c)
    shift_invert_eigs around the port's Solver on Laplace 64^2.  (a) and
    (c) are held to a host shift-invert ARPACK run, (b) to the values
    the JAX package locks on the CPU."""
    import scipy.sparse.linalg as spla
    from hymls_tpu_torch import Preconditioner, Solver
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.solvers.eigen import JDQR, shift_invert_eigs
    from hymls_tpu_torch.stencils import laplace2d
    from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian

    out = {}
    # (a)
    K = laplace2d(64, 64).tocsr()
    params = eig_params(64)
    P = Preconditioner(K, params, device=device).compute()
    ref = np.sort(np.abs(np.real(spla.eigs(
        K.asfptype(), k=10, sigma=0, which="LM",
        return_eigenvectors=False))))
    reset_counts()
    jd = JDQR(K, None, P, params, device=device)
    t, r = wall_median(jd.solve, 1)
    gap = float(np.abs(np.sort(np.abs(r.values)) - ref).max()) \
        if r.converged == 10 else float("inf")
    resid = eig_residuals(K, r)
    n_corr = sum(jd.corrections.values())
    log(f"JDQR Laplace 64^2: {r.converged} converged in {r.iterations} "
        f"outer iterations (JAX CPU {ANCHOR_JDQR}; the config's target <= "
        f"70), max |lambda - ARPACK's| {gap:.1e}, max residual "
        f"{resid:.1e}; {t:.4f} s, {jd.corrections} correction solves, "
        f"{t / max(n_corr, 1) * 1e3:.2f} ms per outer iteration with one; "
        f"dia_spmv launches {dia_matvec.launches} (K is an ELL operator)")
    if r.converged != 10 or r.iterations > 70 or not gap <= 1e-8 or \
            not resid <= 1e-7 or abs(r.iterations - ANCHOR_JDQR) > 5:
        raise RuntimeError(f"JDQR Laplace 64^2: {r.converged} converged "
                           f"in {r.iterations}, gap {gap:.1e}, residual "
                           f"{resid:.1e}")
    out["jdqr"] = {"converged": r.converged, "outer": r.iterations,
                   "solve_s": t, "corrections": dict(jd.corrections),
                   "value_gap": gap, "max_residual": resid,
                   "launches": dia_matvec.launches}

    # (b)
    out["jdqr_pair"] = {}
    for nx, (want, anchor_outer, tol) in ANCHOR_PAIR.items():
        Kc = cavity_jacobian(nx, nx, re=1000.0).tocsr()
        pc_ = eig_params(nx, "Stokes-C", **{
            "How Many": 4, "Convergence Tolerance": 1e-6,
            "Number of Iterations": 80, "Maximum Subspace Dimension": 30,
            "Restart Dimension": 12})
        Pc = Preconditioner(Kc, pc_, device=device).compute()
        jd = JDQR(Kc, None, Pc, pc_, device=device)
        t, r = wall_median(jd.solve, 1)
        vals = np.sort_complex(np.asarray(r.values, dtype=complex))
        want = np.sort_complex(np.asarray(want))
        scale = np.abs(want).max()
        gap = float(np.abs(vals - want).max() / scale) \
            if r.converged == 4 else float("inf")
        pair = int((np.abs(vals.imag) > 1e-3 * scale).sum())
        resid = eig_residuals(Kc, r)
        log(f"JDQR cavity {nx}^2 Re 1000 (n={Kc.shape[0]}): {r.converged} "
            f"converged in {r.iterations} outer iterations (JAX CPU "
            f"{anchor_outer}), values {np.array2string(vals, precision=8)};"
            f" {pair} of them with a nonzero imaginary part; max |lambda - "
            f"JAX CPU's| / |lambda|max {gap:.1e} (tol {tol:g}), max "
            f"residual {resid:.1e}; {jd.corrections} correction solves, "
            f"{t:.4f} s")
        if r.converged != 4 or pair != 2 or jd.corrections["pair"] <= 0 \
                or not gap <= tol or not resid <= 1e-5:
            raise RuntimeError(f"JDQR cavity {nx}^2: {r.converged} "
                               f"converged, {pair} complex values, gap "
                               f"{gap:.1e}, residual {resid:.1e}")
        out["jdqr_pair"][str(nx)] = {
            "converged": r.converged, "outer": r.iterations, "solve_s": t,
            "corrections": dict(jd.corrections), "value_gap_rel": gap,
            "max_residual": resid}

    # (c)
    S = Solver(K, P, params, device=device)
    solves = []
    inner = S.apply_inverse

    def counted(b):
        x, res = inner(b)
        solves.append(res.iters)
        return x, res
    S.apply_inverse = counted
    reset_counts()
    t, r = wall_median(lambda: shift_invert_eigs(K, None, S, k=10,
                                                 target=0.0, tol=1e-10), 1)
    launches = dia_matvec.launches
    gap = float(np.abs(np.sort(np.abs(np.real(r.values))) - ref).max())
    log(f"shift_invert_eigs Laplace 64^2: max |lambda - ARPACK's| "
        f"{gap:.1e}; {len(solves)} inner solves (JAX CPU "
        f"{ANCHOR_SHIFT_INVERT_SOLVES}) of {statistics.median(solves):.0f} "
        f"iterations (median), {t:.4f} s, "
        f"{t / max(len(solves), 1) * 1e3:.2f} ms per solve; dia_spmv "
        f"launches {launches}")
    if not gap <= 1e-8 or launches <= 0 or \
            abs(len(solves) - ANCHOR_SHIFT_INVERT_SOLVES) > 2:
        raise RuntimeError(f"shift_invert_eigs: gap {gap:.1e}, "
                           f"{len(solves)} inner solves, {launches} "
                           f"dia_spmv launches")
    out["shift_invert"] = {"value_gap": gap, "inner_solves": len(solves),
                           "solve_s": t, "launches": launches}
    return out


def drive_configs(device, anchors, jdqr_anchors, tag, override=None):
    """run_with_refinements on the card for every config of `anchors`
    (per config, per refinement, the JAX package's CPU count of every
    solve), with the launch counts set to 0 just before each: every
    config's 'Targets' met, every count within 1 of its anchor, JDQR's
    outer iterations within 5 of `jdqr_anchors[config]`, every solver
    on a DIA operator and the DIA kernel launched.  `override` as in
    driver_cases.driver_params.  Returns the records per config."""
    import hymls_tpu_torch.driver as drv
    from hymls_tpu_torch.config import load_xml
    from hymls_tpu_torch.ops.dia_spmv import dia_matmat, dia_matvec
    from hymls_tpu_torch.ops.spmv import DiaOperator
    from hymls_tpu_torch.solvers import eigen
    from hymls_tpu_torch.tools.driver_cases import (constructed,
                                                    driver_params,
                                                    eigen_results)

    out = {}
    for name, anchor in anchors.items():
        params = driver_params(load_xml, name, override)
        reset_counts()
        with eigen_results(eigen) as got, constructed(drv) as made, \
                deflation_setups() as setups:
            t, reps = wall_median(
                lambda: drv.run_with_refinements(params, device=device), 1)
        launches = dia_matvec.launches
        matmat = dia_matmat.launches
        outer = [r.iterations for r in got]
        jd_anchor = jdqr_anchors.get(name, [])
        iters = [[s.iters for s in r.solves] for r in reps]
        relres = max(s.relres for r in reps for s in r.solves)
        relerr = max(s.relerr for r in reps for s in r.solves)
        failures = [f for r in reps for f in r.failures]
        times = [(r.solves[-1].compute_time, r.solves[-1].solve_time)
                 for r in reps]
        structured = [P._structured_active for P in made["P"]]
        dia = any(isinstance(S.op, DiaOperator) for S in made["S"])
        jd = f", JDQR outer {outer} (JAX CPU {jd_anchor})" if outer else ""
        log(f"{tag} {name}: iterations {iters} (JAX CPU {anchor}), "
            f"max relres {relres:.2e}, max relerr {relerr:.2e}, "
            f"targets {'met' if not failures else failures}{jd}; "
            f"{f'{override[0][-1]!r} {override[1]}, ' if override else ''}"
            f"apply {['structured' if a else 'generic' for a in structured]}; "
            f"{t:.2f} s in all, (compute, solve) s per refinement "
            f"{[(round(c, 4), round(v, 4)) for c, v in times]}; "
            f"dia_spmv launches {launches}, dia_matmat {matmat}")
        for i, rec in enumerate(setups):
            log(f"{tag} {name} deflation {i}: k={rec['k']}; "
                f"{setup_line(rec)}")
        if any(rec["matmat_launches"] <= 0 for rec in setups):
            raise RuntimeError(f"a deflation setup of {tag} {name} never "
                               f"launched dia_matmat")
        if failures or [len(i) for i in iters] != \
                [len(a) for a in anchor] or any(
                    abs(x - y) > 1 for i, a in zip(iters, anchor)
                    for x, y in zip(i, a)):
            raise RuntimeError(f"{tag} {name}: iterations {iters}, "
                               f"JAX CPU {anchor}; {failures}")
        if len(outer) != len(jd_anchor) or any(
                abs(x - y) > 5 for x, y in zip(outer, jd_anchor)):
            raise RuntimeError(f"{tag} {name}: JDQR outer {outer}, "
                               f"JAX CPU {jd_anchor}")
        if not dia or launches <= 0:
            raise RuntimeError(f"the {tag} {name} path launched dia_spmv "
                               f"{launches} times (a DIA operator: {dia})")
        out[name] = {"iters": iters, "max_relres": relres,
                     "max_relerr": relerr, "seconds": t,
                     "compute_solve_s": times, "launches": launches,
                     "matmat_launches": matmat,
                     "deflation_setups": setups,
                     "structured": structured, "dia_operator": dia,
                     **({"jdqr_outer": list(outer)} if outer else {})}
    return out


def drive_driver(device):
    """Phase 22: run_with_refinements on the card for every config of
    ANCHOR_DRIVER; then the driver's command line in a subprocess."""
    out = drive_configs(device, ANCHOR_DRIVER,
                        {"laplace1_eigs": ANCHOR_DRIVER_JDQR}, "driver")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "hymls_tpu_torch.driver",
                        os.path.join("configs", "laplace1.xml")],
                       cwd=HERE, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=HERE))
    t = time.perf_counter() - t0
    tail = p.stdout.strip().splitlines()[-1:] or [""]
    log(f"python -m hymls_tpu_torch.driver configs/laplace1.xml: exit "
        f"{p.returncode}, last line {tail[0]!r}, {t:.2f} s")
    if p.returncode != 0 or tail[0] != "ALL TESTS PASSED":
        raise RuntimeError(f"the driver's command line failed "
                           f"({p.returncode}):\n{p.stdout[-4000:]}"
                           f"\n{p.stderr[-4000:]}")
    out["command_line"] = {"config": "laplace1", "exit": p.returncode,
                           "seconds": t}
    return out


def drive_suite(device):
    """Phase 27: every config of driver_cases.SUITE_CONFIGS through the
    driver on the card (drive_configs, against ANCHOR_SUITE), then each
    config of SUITE_GENERIC once more with 'Structured Apply' False."""
    from hymls_tpu_torch.tools.driver_cases import SUITE_CONFIGS
    t0 = time.perf_counter()
    out = {"auto": drive_configs(
        device, {n: ANCHOR_SUITE[n] for n in SUITE_CONFIGS},
        ANCHOR_SUITE_JDQR, "suite")}
    for name in SUITE_GENERIC:
        if out["auto"][name]["structured"] != [True]:
            raise RuntimeError(f"suite {name}: \"Auto\" took the generic "
                               f"apply; SUITE_GENERIC lists configs on "
                               f"the structured one")
    out["generic"] = drive_configs(
        device, {n: ANCHOR_SUITE[n] for n in SUITE_GENERIC}, {},
        "suite generic", (("Preconditioner", "Structured Apply"), False))
    for name in SUITE_GENERIC:
        a, g = out["auto"][name], out["generic"][name]
        log(f"suite {name}: solve s structured "
            f"{a['compute_solve_s'][0][1]:.4f}, generic "
            f"{g['compute_solve_s'][0][1]:.4f}; compute s "
            f"{a['compute_solve_s'][0][0]:.4f} / "
            f"{g['compute_solve_s'][0][0]:.4f}")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 27 in {out['seconds']:.1f} s")
    return out


def plan_layer_trace(K, params, tv, device):
    """(record, P): an f32 Preconditioner of K built under
    torch.profiler, with the seconds of each `hymls.plan*` span on the
    profiler's clock, the constructor's wall seconds and the plan
    counters it added (`hymls.plan.builds`, `.cache_loads`,
    `.device_bytes`)."""
    from torch.profiler import ProfilerActivity, profile
    from hymls_tpu_torch import Preconditioner
    from hymls_tpu_torch.utils import timings
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before = timings.counter_snapshot()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        P = Preconditioner(K, params, dtype=torch.float32, device=device,
                           testvector=tv)
        if cuda:
            torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    now = timings.counter_snapshot()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("hymls.plan"):
            spans[e.name()] = spans.get(e.name(), 0.0) + \
                e.duration_ns() * 1e-9
    rec = {"setup_s": setup_s, "plan_s": P.plan_seconds,
           "from_cache": P.plan_from_cache, "spans_s": spans,
           "counters": {k: now.get("hymls.plan." + k, 0) -
                        before.get("hymls.plan." + k, 0)
                        for k in ("builds", "cache_loads", "device_bytes")}}
    log(f"plan layer: constructor {setup_s:.2f} s ("
        f"{'from the cache' if P.plan_from_cache else 'built'}); spans s "
        f"{ {k: round(v, 3) for k, v in spans.items()} }; counters "
        f"{rec['counters']}")
    return rec, P


def apply_counters(before):
    """The apply-graph counters since the snapshot `before`."""
    from hymls_tpu_torch.utils import timings
    now = timings.counter_snapshot()
    return {k[len("hymls.apply."):]: now.get(k, 0) - before.get(k, 0)
            for k in ("hymls.apply.graph_captures",
                      "hymls.apply.graph_replays", "hymls.apply.eager")}


def held_apply(tag, P, b, captures=1):
    """The replayed apply of `P` on `b` against its eager apply, bit for
    bit, with its counters; host issue and CUDA-event time per apply of
    both, and the first apply's ms (warm-up, capture and replay)."""
    from hymls_tpu_torch.utils import timings
    f = P.factors
    before = timings.counter_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x1 = P.apply_fn(f, b)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    x2 = P.apply_fn(f, b)
    e = P._apply_eager(f, b)
    c = apply_counters(before)
    if not (torch.equal(x1, e) and torch.equal(x2, e)):
        raise RuntimeError(f"{tag}: the replayed apply differs from the "
                           f"eager one by "
                           f"{float((x2 - e).abs().max()):.3e}")
    if c != {"graph_captures": captures, "graph_replays": 2,
             "eager": 1}:
        raise RuntimeError(f"{tag}: counters {c}")
    rec = {"n": b.shape[-1], "shape": list(b.shape),
           "first_apply_ms": first_ms,
           "issue_us": issue_us(lambda: P.apply_fn(f, b)),
           "eager_issue_us": issue_us(lambda: P._apply_eager(f, b)),
           "event_us": 1e3 * event_ms(lambda: P.apply_fn(f, b),
                                      reps=10, inner=10, warmup=2),
           "eager_event_us": 1e3 * event_ms(
               lambda: P._apply_eager(f, b), reps=10, inner=10,
               warmup=2)}
    log(f"apply graph {tag}: {list(b.shape)} {b.dtype}, equal to the "
        f"eager apply bit for bit; first apply (warm-up, capture, "
        f"replay) {first_ms:.2f} ms; host issue {rec['issue_us']:.1f} "
        f"us, eager {rec['eager_issue_us']:.1f}; per apply (CUDA "
        f"events) {rec['event_us']:.1f} us, eager "
        f"{rec['eager_event_us']:.1f}")
    return rec


def drive_apply_graph(device):
    """Phase 28: the V-cycle apply replayed from its CUDA graph
    (core/apply_graph.py) against the eager apply (`_apply_eager`), bit
    for bit: cavity128 on one level (the inverse of a coarse of more
    than 2048 unknowns), a B = 8 block, stokes2 128^2 on three levels,
    the 8^3 B-grid configuration (K1 inside the graph), the stale factor
    (capture on K_1, compute(K_2), the apply equal to the eager one on
    K_2), a Newton sequence of recaptures (the memory reserved must not
    grow), a capture under torch.profiler and a capture that raises
    (eager, then a capture of another key again).  Host issue and CUDA
    event time per apply of both, and each capture's ms (the first
    apply: warm-up, capture and replay).  At 32^3 the plan build and
    its store take ~25-35 s of the phase."""
    import warnings
    from hymls_tpu_torch import Preconditioner
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.stencils import create_matrix, create_testvector
    from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian
    from hymls_tpu_torch.utils import timings

    def f32(K, params):
        P = Preconditioner(K, params, dtype=torch.float32, device=device,
                           testvector=create_testvector(params, K))
        return P.compute()

    def vec(n, *shape, seed=0):
        return torch.randn(*shape, n, dtype=torch.float32, device=device,
                           generator=torch.Generator(device).manual_seed(
                               seed))

    t_start = time.perf_counter()
    out = {}
    # cavity128, one level: the large coarse held as its inverse
    p = cavity64_params()
    p.sublist("Problem")["nx"] = p.sublist("Problem")["ny"] = 128
    K = cavity_jacobian(128, 128, re=1000.0).tocsr()
    P = f32(K, p)
    if set(P.factors.tree["coarse"]) != {"inv"}:
        raise RuntimeError("cavity128: the coarse solve is not the inverse")
    n = K.shape[0]
    b = vec(n)
    out["cavity128"] = held_apply("cavity128", P, b)
    out["cavity128_B8"] = held_apply("cavity128 B=8", P, vec(n, 8, seed=1))
    # the stale factor: capture on K_1, compute(K_2)
    x_k1 = P.apply_fn(P.factors, b)
    P.compute(cavity_jacobian(128, 128, re=950.0).tocsr())
    out["cavity128_stale"] = held_apply("cavity128 after compute(K_2)", P, b)
    if torch.equal(x_k1, P._apply_eager(P.factors, b)):
        raise RuntimeError("compute(K_2) left the apply unchanged")
    # a Newton sequence: compute, capture, replays; nothing may pile up
    reserved, capture_ms = [], []
    before = timings.counter_snapshot()
    for k, re in enumerate((960.0, 1010.0, 1040.0, 990.0)):
        P.compute(cavity_jacobian(128, 128, re=re).tocsr())
        f = P.factors
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P.apply_fn(f, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        P.apply_fn(f, b)
        torch.cuda.synchronize()
        capture_ms.append((2 * t1 - t0 - time.perf_counter()) * 1e3)
        reserved.append(torch.cuda.memory_reserved())
    out["newton_sequence"] = {"capture_ms": capture_ms, "reserved_B": reserved,
                              "peak_B": torch.cuda.max_memory_allocated()}
    log(f"apply graph cavity128 Newton sequence: capture ms (first apply "
        f"less a replay) {[round(c, 2) for c in capture_ms]}; memory "
        f"reserved {reserved} B; peak allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    c = apply_counters(before)
    if reserved[-1] > reserved[1] or c != {
            "graph_captures": 4, "graph_replays": 8, "eager": 0}:
        raise RuntimeError(f"the recaptures: counters {c}, memory reserved "
                           f"{reserved}")
    # a capture under the profiler
    from torch.profiler import ProfilerActivity, profile
    before = timings.counter_snapshot()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        P.compute(K)
        xs = [P.apply_fn(P.factors, b) for _ in range(3)]
        torch.cuda.synchronize()
    e = P._apply_eager(P.factors, b)
    c = apply_counters(before)
    if not all(torch.equal(x, e) for x in xs) or c["graph_captures"] != 1:
        raise RuntimeError(f"cavity128 under the profiler: counters {c}, "
                           f"equal {[torch.equal(x, e) for x in xs]}")
    log("apply graph cavity128: captured under torch.profiler, equal to "
        "the eager apply")
    # a capture that raises: eager for its key, captures again after
    f = P.factors

    def syncing(f, v):
        float(v.sum())
        return P._apply_body(f, v)

    b2 = vec(n, 2, seed=2)
    before = timings.counter_snapshot()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        y = P._graphs(syncing, f, b2)
    c = apply_counters(before)
    if not torch.equal(y, P._apply_eager(f, b2)) or c != {
            "graph_captures": 0, "graph_replays": 0, "eager": 1} or \
            not any("could not be captured" in str(m.message) for m in w):
        raise RuntimeError(f"a capture that raises: counters {c}, "
                           f"{[str(m.message) for m in w]}")
    out["cavity128_after_failed_capture"] = held_apply(
        "cavity128 B=3 after a failed capture", P, vec(n, 3, seed=3))
    del P
    # stokes2 128^2, three levels
    p = stokes_params(128, 2, 3, "Skew Cartesian")
    K = create_matrix(p).tocsr()
    P = f32(K, p)
    if not P._structured_active:
        raise RuntimeError("stokes2 128^2 L3: not the structured apply")
    out["stokes2_128_L3"] = held_apply("stokes2 128^2 L3", P, vec(K.shape[0]))
    del P
    # upstream's stokes2_3D at 32^3, two levels: the generic gather apply,
    # its preconditioner built cold into a fresh plan cache and built
    # again from it, each under the profiler (the plan layer's spans)
    p = stokes_params(32, 3, 2, "Skew Cartesian", maxiter=160, tol=1e-8)
    pre = p.sublist("Preconditioner")
    pre["Coarsening Factor"] = 2
    pre["Eliminate Velocities Together"] = False
    K = create_matrix(p).tocsr()
    with tempfile.TemporaryDirectory() as d, plan_cache(d):
        cold, P = plan_layer_trace(K, p, create_testvector(p, K), device)
        del P
        cached, P = plan_layer_trace(K, p, create_testvector(p, K), device)
        stored = [os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)]
    plan = {"cold": cold, "cached": cached, "stored_bytes": stored}
    if P._structured_active:
        raise RuntimeError("stokes3d 32^3 L2: not the generic apply")
    if cold["counters"]["builds"] != 1 or \
            cached["counters"]["cache_loads"] != 1 or len(stored) != 1 or \
            "hymls.plan.cache_store" not in cold["spans_s"] or \
            "hymls.plan.build" in cached["spans_s"]:
        raise RuntimeError(f"stokes3d 32^3 L2 plan layer: {plan}")
    P.compute()
    out["stokes3d_32_L2"] = rec = held_apply("stokes3d 32^3 L2 generic", P,
                                       vec(K.shape[0]))
    rec.update(plan=plan, coarse_n=P.coarse_plan.n,
               structured_reason=P._structured_reason)
    log(f"apply graph stokes3d 32^3 L2: coarse {P.coarse_plan.n}, "
        f"structured apply refused: {P._structured_reason}; plan file "
        f"{stored} B")
    del P
    # the B-grid transform: K1 inside the graph
    p = stokes_l2_params(8, True)
    K = create_matrix(p).tocsr()
    P = f32(K, p)
    reset_counts()
    out["stokes_L2_8_bgrid"] = rec = held_apply("stokes_L2 8^3 B-grid", P,
                                          vec(K.shape[0]))
    rec["dia_spmv_wrapper_calls"] = dia_matvec.launches
    if P._bgrid is None or dia_matvec.launches < 4:
        raise RuntimeError(f"B-grid: {dia_matvec.launches} K1 wrapper calls")
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 28 in {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def coarse_branch(kind):
    """`dense_factor` on the card as it is ("inv": the explicit inverse
    at every size) or with the CPU's branch forced ("lu": LU factors
    above 2048 unknowns)."""
    from hymls_tpu_torch.core import dense
    orig = dense.on_accelerator
    if kind == "lu":
        dense.on_accelerator = lambda A: False
    try:
        yield
    finally:
        dense.on_accelerator = orig


#: the coarse factor's keys on each branch
COARSE_KEYS = {"lu": {"lu", "piv"}, "inv": {"inv"}}


def coarse_branches(tag, P, b):
    """Phase 29 for one preconditioner: per branch, in turns (LU,
    inverse, inverse, LU), the cold factor of the coarse matrix by CUDA
    events, then compute() and the replayed apply against the eager
    one (`held_apply`); max|I - A X| of the inverse."""
    from hymls_tpu_torch.core import dense
    A = coarse_matrix(P)
    out = {"n": A.shape[0], "dtype": str(A.dtype), "lu": [], "inv": []}
    for kind in ("lu", "inv", "inv", "lu"):
        with coarse_branch(kind):
            ms = event_ms(lambda: dense.dense_factor(A), reps=3, inner=1,
                          warmup=1)
            P.compute()
            coarse = P.factors.full["coarse"]
            if set(coarse) != COARSE_KEYS[kind]:
                raise RuntimeError(f"{tag}: coarse factor {sorted(coarse)} "
                                   f"on the {kind} branch")
            rec = held_apply(f"{tag} coarse {kind}", P, b)
        rec["factor_ms"] = ms
        out[kind].append(rec)
        log(f"coarse {tag} {kind}: n = {A.shape[0]} {A.dtype}, cold coarse "
            f"factor {ms:.2f} ms (CUDA events, median of 3); replayed "
            f"apply {rec['event_us']:.1f} us")
        if kind == "inv" and "inv_residual" not in out:
            out["inv_residual"] = coarse_inverse_residual(P)[1]
            log(f"coarse {tag} inverse: max|I - A X| = "
                f"{out['inv_residual']:.3e} (f64)")
    torch.cuda.empty_cache()
    return out


def coarse_warm_times(solvers, K, b, rounds: int = 3):
    """Phase 29's Newton sequence on cavity128: each branch's solver in
    turns (LU, inverse, inverse, LU per round), on values scaled anew per
    call: compute() against recompute(), newton_step against
    newton_step_warm threading each branch's factors, with their inner
    iterations and the warm step's true f64 relres."""
    order = ("lu", "inv", "inv", "lu")
    samples = {t: {"compute": [], "recompute": [], "cold_step": [],
                   "warm_step": []} for t in solvers}
    iters = {t: {"cold": [], "warm": []} for t in solvers}
    facs = {t: solvers[t].precond.factors for t in solvers}
    worst = 0.0
    j = 0
    for _ in range(rounds):
        for kind in order:
            S = solvers[kind]
            P = S.precond
            s_ = samples[kind]
            j += 1
            s = 1.0 + 1e-6 * j
            with coarse_branch(kind):
                s_["compute"].append(wall_median(
                    lambda: P.compute(scaled(K, s)), 1)[0])
                s_["recompute"].append(wall_median(
                    lambda: P.recompute(scaled(K, s + 5e-7)), 1)[0])
                v64, v32 = S.op64.vals * s, S.solver.op.vals * s
                t, r = wall_median(lambda: S.newton_step(v64, v32, b), 1)
                s_["cold_step"].append(t)
                iters[kind]["cold"].append(r.iters)
                t, (r, facs[kind]) = wall_median(
                    lambda: S.newton_step_warm(v64, v32, b, facs[kind]), 1)
                s_["warm_step"].append(t)
                iters[kind]["warm"].append(r.iters)
                if set(facs[kind].full["coarse"]) != COARSE_KEYS[kind]:
                    raise RuntimeError(f"warm {kind}: coarse factor "
                                       f"{sorted(facs[kind].full['coarse'])}")
            relres = true_relres(scaled(K, s), r.x, b)
            worst = max(worst, relres)
            if not relres <= RELRES_OK:
                raise RuntimeError(f"cavity128 warm step on the {kind} "
                                   f"branch: relres {relres:.3e}")
    out = {"worst_relres": worst}
    for kind in solvers:
        med = {k: statistics.median(x) for k, x in samples[kind].items()}
        out[kind] = {**{f"{k}_s": v for k, v in med.items()},
                     "iters": iters[kind]}
        log(f"coarse cavity128 {kind} Newton sequence: compute "
            f"{med['compute']:.4f} s, recompute {med['recompute']:.4f} s; "
            f"newton_step {med['cold_step']:.4f} s, newton_step_warm "
            f"{med['warm_step']:.4f} s (median of {2 * rounds}, "
            f"interleaved, wall clock); inner iterations cold "
            f"{iters[kind]['cold']}, warm {iters[kind]['warm']}")
    log(f"coarse cavity128 Newton sequence: worst true f64 relres of a "
        f"warm step {worst:.3e}")
    return out


def drive_coarse_inverse(device):
    """Phase 29: the large coarse system held as its explicit inverse on
    the card against LU factors, the CPU's branch forced
    (`coarse_branch`): cavity128 on one level and upstream's stokes2_3D
    at 32^3 on two (`coarse_branches`), then cavity128's Newton
    sequence on each branch (`coarse_warm_times`).  The 32^3 plan build
    takes ~25 s of the phase."""
    from hymls_tpu_torch import Preconditioner
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    from hymls_tpu_torch.stencils import create_matrix, create_testvector
    from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian

    def vec(n):
        return torch.randn(n, dtype=torch.float32, device=device,
                           generator=torch.Generator(device).manual_seed(0))

    t_start = time.perf_counter()
    out = {}
    p = cavity64_params()
    p.sublist("Problem")["nx"] = p.sublist("Problem")["ny"] = 128
    K = cavity_jacobian(128, 128, re=1000.0).tocsr()
    P = Preconditioner(K, p, dtype=torch.float32, device=device,
                       testvector=create_testvector(p, K))
    out["cavity128"] = coarse_branches("cavity128", P, vec(K.shape[0]))
    del P
    p3 = stokes_params(32, 3, 2, "Skew Cartesian", maxiter=160, tol=1e-8)
    pre = p3.sublist("Preconditioner")
    pre["Coarsening Factor"] = 2
    pre["Eliminate Velocities Together"] = False
    K3 = create_matrix(p3).tocsr()
    P = Preconditioner(K3, p3, dtype=torch.float32, device=device,
                       testvector=create_testvector(p3, K3))
    out["stokes3d_32_L2"] = coarse_branches("stokes3d 32^3 L2", P,
                                            vec(K3.shape[0]))
    del P, K3
    b = K @ np.random.default_rng(0).standard_normal(K.shape[0])
    solvers = {}
    for kind in ("lu", "inv"):
        with coarse_branch(kind):
            S = IterativeRefinementSolver(
                K, p, testvector=create_testvector(p, K), device=device)
            S.compute()
        solvers[kind] = S
    out["warm"] = coarse_warm_times(solvers, K, b)
    del solvers, S
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 29 in {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def gmres_path(kind):
    """GMRES on the card as it is ("graph": each iteration replayed from
    the process's workspaces, solvers/krylov.py:GmresGraphs), from a new
    empty cache ("fresh": nothing captured yet) or op by op ("eager": a
    workspace cache that takes no CUDA tensor)."""
    from hymls_tpu_torch.solvers import krylov
    orig = krylov._GRAPHS
    if kind == "eager":
        krylov._GRAPHS = krylov.GmresGraphs(device_type="none")
    elif kind == "fresh":
        krylov._GRAPHS = krylov.GmresGraphs()
    try:
        yield
    finally:
        krylov._GRAPHS = orig


def gmres_counters(before):
    """The GMRES graph counters since the snapshot `before`."""
    from hymls_tpu_torch.utils import timings
    now = timings.counter_snapshot()
    return {k[len("hymls.gmres."):]: now.get(k, 0) - before.get(k, 0)
            for k in ("hymls.gmres.graph_captures",
                      "hymls.gmres.graph_replays", "hymls.gmres.eager",
                      "hymls.gmres.iters")}


def busy_and_syncs(fn):
    """(device busy us, synchronizing runtime calls) of one call of `fn`
    under torch.profiler: the union of the kernel and copy intervals,
    and the cuda*Synchronize calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, syncs = [], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
        elif "Synchronize" in e.name:
            syncs += 1
    busy, at = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > at:
            busy += t - max(s, at)
            at = t
    return busy, syncs


def graph_pool_bytes(spaces):
    """(bytes of the segments, bytes allocated in them) of the memory
    pools that the workspaces' graphs were captured into."""
    pools = {ws.backend.pool for ws in spaces if ws.backend.pool is not None}
    seg = alloc = 0
    for x in torch.cuda.memory_snapshot():
        if tuple(x.get("segment_pool_id", ())) in pools:
            seg += x["total_size"]
            alloc += x["allocated_size"]
    return seg, alloc


def gmres_graph_case(tag, S, b, rounds: int = 2):
    """Phase 30 for one refinement solver: the solve of b with GMRES's
    iterations replayed and op by op, in turns (graph, eager, eager,
    graph per round): x equal bit for bit and the same inner
    iterations; the first graph solve's captures and the memory the
    workspace and its graphs took; wall and CUDA-event us per inner
    iteration of each side, device busy us per iteration and
    synchronizing calls per iteration (torch.profiler), and the
    synchronizing calls of one solve by their Python line (torch's sync
    debug mode)."""
    import warnings
    from hymls_tpu_torch.solvers import krylov
    from hymls_tpu_torch.utils import timings
    with gmres_path("eager"):
        x_ref = S.solve(b)
        iters = S.num_iter
    torch.cuda.synchronize()
    alloc0, reserved0 = (torch.cuda.memory_allocated(),
                         torch.cuda.memory_reserved())
    before = timings.counter_snapshot()
    t0 = time.perf_counter()
    x = S.solve(b)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    c = gmres_counters(before)
    spaces = [ws for key, ws in krylov._GRAPHS._spaces.items()
              if key[0] == b.shape[0]]
    rec = {"n": b.shape[0], "inner_iters": iters, "first_solve_s": first_s,
           "first_solve_counters": c,
           "workspace_bytes": sum(
               t.numel() * t.element_size() for ws in spaces
               for t in (ws.V, ws.R, ws.g, ws.Q, ws.eye, ws.w, ws.scale)),
           "graphs": sum(len(ws.graphs) for ws in spaces),
           "allocated_delta_B": torch.cuda.memory_allocated() - alloc0,
           "reserved_delta_B": torch.cuda.memory_reserved() - reserved0,
           "graph_pool_B": graph_pool_bytes(spaces)}
    if not torch.equal(x, x_ref) or S.num_iter != iters or \
            c["graph_captures"] == 0 or c["eager"] != c["graph_captures"] \
            or c["graph_replays"] + c["eager"] != iters:
        raise RuntimeError(f"{tag}: first graph solve: counters {c}, "
                           f"iterations {S.num_iter} against {iters}, x "
                           f"equal {torch.equal(x, x_ref)}")
    sides = {"graph": {"wall_us": [], "event_us": []},
             "eager": {"wall_us": [], "event_us": []}}
    for _ in range(rounds):
        for kind in ("graph", "eager", "eager", "graph"):
            with gmres_path(kind):
                before = timings.counter_snapshot()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                x = S.solve(b)
                end.record()
                end.synchronize()
                wall = time.perf_counter() - t0
                c = gmres_counters(before)
            want = {"graph_captures": 0, "graph_replays": iters, "eager": 0,
                    "iters": iters} if kind == "graph" else {
                "graph_captures": 0, "graph_replays": 0, "eager": iters,
                "iters": iters}
            if not torch.equal(x, x_ref) or c != want:
                raise RuntimeError(f"{tag} {kind}: counters {c}, x equal "
                                   f"{torch.equal(x, x_ref)}")
            sides[kind]["wall_us"].append(wall * 1e6 / iters)
            sides[kind]["event_us"].append(
                start.elapsed_time(end) * 1e3 / iters)
    for kind, side in sides.items():
        with gmres_path(kind):
            busy, syncs = busy_and_syncs(lambda: S.solve(b))
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    S.solve(b)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        lines = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                at = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                lines[at] = lines.get(at, 0) + 1
        side.update(busy_us_per_iter=busy / iters,
                    syncs_per_iter=syncs / iters, sync_lines=lines)
        side["wall_us_median"] = statistics.median(side["wall_us"])
        side["event_us_median"] = statistics.median(side["event_us"])
        log(f"gmres graph {tag} {kind}: {iters} inner iterations, per "
            f"iteration wall {side['wall_us_median']:.1f} us, CUDA events "
            f"{side['event_us_median']:.1f} us (medians of {2 * rounds}, "
            f"interleaved), device busy {side['busy_us_per_iter']:.1f} us; "
            f"{side['syncs_per_iter']:.3f} synchronizing calls an "
            f"iteration (profiler); by line (sync debug mode) {lines}")
    rec.update(sides)
    log(f"gmres graph {tag}: x equal bit for bit on both paths; first "
        f"graph solve {first_s:.4f} s with {rec['graphs']} captures; "
        f"workspace {rec['workspace_bytes']} B, memory allocated "
        f"+{rec['allocated_delta_B']} B, reserved +{rec['reserved_delta_B']}"
        f" B; the graphs' pool (segments, allocated) {rec['graph_pool_B']} B")
    return rec


def drive_gmres_graph(device):
    """Phase 30: GMRES's iterations replayed from CUDA graphs against the
    eager loop on the benchmark's two claimed resolve configurations,
    cavity128 on one level and upstream's stokes2_3D at 32^3 on two
    (`gmres_graph_case`).  The 32^3 plan build takes ~25 s of the
    phase."""
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    from hymls_tpu_torch.stencils import create_matrix, create_testvector
    from hymls_tpu_torch.stencils.navier_stokes import cavity_jacobian

    t_start = time.perf_counter()
    out = {}
    p = cavity64_params()
    p.sublist("Problem")["nx"] = p.sublist("Problem")["ny"] = 128
    K = cavity_jacobian(128, 128, re=1000.0).tocsr()
    p3 = stokes_params(32, 3, 2, "Skew Cartesian", maxiter=160, tol=1e-8)
    pre = p3.sublist("Preconditioner")
    pre["Coarsening Factor"] = 2
    pre["Eliminate Velocities Together"] = False
    for tag, params, mat in (("cavity128", p, lambda: K),
                             ("stokes3d 32^3 L2", p3,
                              lambda: create_matrix(p3).tocsr())):
        Kc = mat()
        S = IterativeRefinementSolver(
            Kc, params, testvector=create_testvector(params, Kc),
            device=device).compute()
        b = Kc @ np.random.default_rng(0).standard_normal(Kc.shape[0])
        # a new cache: the earlier phases' solves of the same shapes
        # captured into the process's one
        with gmres_path("fresh"):
            out[tag] = gmres_graph_case(tag, S, torch.as_tensor(
                b, dtype=torch.float64, device=device))
        relres = true_relres(Kc, S.solve(b), b)
        tol = params.sublist("Solver").sublist("Iterative Solver")[
            "Convergence Tolerance"]
        if not relres <= tol:
            raise RuntimeError(f"{tag}: relres {relres:.3e} above {tol}")
        out[tag]["relres"] = relres
        del S
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 30 in {out['seconds']:.1f} s")
    return out


def timed_rpc(cli, req):
    """(response, s) of one bridge request with its file round trip."""
    t0 = time.perf_counter()
    resp = cli.rpc(req)
    return resp, time.perf_counter() - t0


def drive_bridge(device):
    """Phase 23: the bridge server on the card against an in-process
    preconditioner on the card built from the same files."""
    import scipy.io as sio
    from hymls_tpu_torch import Preconditioner
    from hymls_tpu_torch.config import load_xml, save_xml
    from hymls_tpu_torch.matlab_bridge import BridgeClient
    from hymls_tpu_torch.stencils import create_testvector
    from hymls_tpu_torch.utils.io import read_matrix, read_multivector

    K0, _ = cavity64()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        sio.mmwrite(os.path.join(d, "A.mtx"), K0)
        sio.mmwrite(os.path.join(d, "A2.mtx"), (K0 * 1.5).tocsr())
        save_xml(cavity64_params(), os.path.join(d, "params.xml"))
        X = np.random.default_rng(4).standard_normal((K0.shape[0], 2))
        sio.mmwrite(os.path.join(d, "x.mtx"), X)
        # what the server reads
        K, K2 = (read_matrix(os.path.join(d, f)).tocsr()
                 for f in ("A.mtx", "A2.mtx"))
        params = load_xml(os.path.join(d, "params.xml"))
        X = np.asarray(read_multivector(os.path.join(d, "x.mtx")))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "hymls_tpu_torch.matlab_bridge", d,
             "--device", str(device)],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            cli = BridgeClient(d, proc)
            cli.wait(os.path.join(d, "server.ready"))
            t_start = time.perf_counter() - t0
            resp, t_init = timed_rpc(cli, {"cmd": "init", "matrix": "A.mtx",
                                           "params": "params.xml"})
            P = Preconditioner(K, params, device=device,
                               testvector=create_testvector(params, K))
            P.compute()
            errs, t_apply = [], []
            for Kc in (K, K2):
                if Kc is K2:
                    _, t_compute = timed_rpc(cli, {"cmd": "compute",
                                                   "matrix": "A2.mtx"})
                    P.compute(K2)
                _, t = timed_rpc(cli, {"cmd": "apply", "x": "x.mtx",
                                       "y": "y.mtx"})
                t_apply.append(t)
                Y = np.asarray(sio.mmread(os.path.join(d, "y.mtx")))
                ref = np.stack([P.apply_inverse(X[:, j]).cpu().numpy()
                                for j in range(X.shape[1])], axis=1)
                errs.append(float(np.abs(Y - ref).max() /
                                  np.abs(ref).max()))
            cli.rpc({"cmd": "free"})
            code = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            proc.stdout.close()
    log(f"bridge on the card (cavity64, n={K.shape[0]}): server ready "
        f"{t_start:.2f} s after start, init {t_init:.3f} s, apply of 2 "
        f"columns {t_apply[0]:.3f} s, compute {t_compute:.3f} s, apply "
        f"{t_apply[1]:.3f} s (each with its file round trip); max |Y - "
        f"in-process|/|Y|max {max(errs):.1e} (before and after compute "
        f"{errs[0]:.1e}, {errs[1]:.1e}); server exit {code}")
    if resp["n"] != K.shape[0] or code != 0 or not max(errs) <= 1e-12:
        raise RuntimeError(f"bridge: n {resp['n']}, exit {code}, errors "
                           f"{errs}")
    out.update(n=K.shape[0], start_s=t_start, init_s=t_init,
               apply_s=t_apply, compute_s=t_compute, max_rel_err=max(errs),
               exit=code)
    return out


def drive_plan_cache(device, cache_dir, cold):
    """Phase 24: stokes32cube_skew_L2 constructed again over the plan
    disk cache that phase 17's cold build (`cold`, its numbers) stored
    in the fresh directory `cache_dir`: the plans load, none is built;
    the Newton step after the load."""
    from hymls_tpu_torch.ops.dia_spmv import dia_matvec
    from hymls_tpu_torch.solvers.mixed import IterativeRefinementSolver
    from hymls_tpu_torch.stencils import create_testvector

    params, K, b = stokes32cube_case()
    tv = create_testvector(params, K)
    stored = [os.path.getsize(os.path.join(cache_dir, f))
              for f in os.listdir(cache_dir) if f.endswith(".pkl")]
    reset_counts()
    with plan_cache(cache_dir):
        t_warm, S = wall_median(lambda: IterativeRefinementSolver(
            K, params, testvector=tv, device=device), 1)
    P = S.precond
    t_compute, _ = wall_median(S.compute, 1)
    t_step, res = wall_median(
        lambda: S.newton_step(S.op64.vals, S.solver.op.vals, b), 1)
    launches = dia_matvec.launches
    relres = true_relres(K, res.x, b)
    out = {"cold_plan_s": cold["plan_s"], "warm_plan_s": P.plan_seconds,
           "cold_setup_s": cold["setup_s"], "warm_setup_s": t_warm,
           "stored_bytes": stored, "inner": res.iters, "relres": relres,
           "compute_s": t_compute, "newton_step_s": t_step,
           "launches": launches}
    log(f"plan cache stokes32cube_skew_L2: phase 17's cold build stored "
        f"{len(stored)} plan file(s) of {sum(stored) / 1e6:.1f} MB; host "
        f"plans built in {cold['plan_s']:.2f} s there, loaded in "
        f"{P.plan_seconds:.3f} s here; constructor {cold['setup_s']:.2f} s "
        f"cold (the store included), {t_warm:.2f} s from the cache; then "
        f"compute {t_compute:.4f} s, newton_step {t_step:.4f} s: inner f32 "
        f"iterations {res.iters} (phase 17 {cold['inner']}, JAX CPU "
        f"{ANCHOR_STOKES32}), true f64 relres {relres:.3e}; dia_spmv "
        f"launches {launches}")
    if len(stored) != 1 or cold["plan_from_cache"] or \
            not P.plan_from_cache:
        raise RuntimeError(f"plan cache: stored {stored}, cold from cache "
                           f"{cold['plan_from_cache']}, warm from cache "
                           f"{P.plan_from_cache}")
    if not relres <= 1e-7 or res.iters > 500 or \
            abs(res.iters - ANCHOR_STOKES32) > \
            STOKES32_BAND * ANCHOR_STOKES32 or launches <= 0:
        raise RuntimeError(f"plan cache stokes32cube: {res.iters} inner "
                           f"iterations, relres {relres:.3e}, {launches} "
                           f"dia_spmv launches")
    return out


@contextlib.contextmanager
def plan_cache(d):
    """HYMLS_PLAN_CACHE set to `d` inside the block, restored after."""
    old = os.environ.get("HYMLS_PLAN_CACHE")
    os.environ["HYMLS_PLAN_CACHE"] = d
    try:
        yield
    finally:
        if old is None:
            del os.environ["HYMLS_PLAN_CACHE"]
        else:
            os.environ["HYMLS_PLAN_CACHE"] = old


def drive_distributed(device):
    """Phase 25 (module docstring): 4 ranks on `device` over gloo, then
    a world-size-1 NCCL group.  Returns the numbers."""
    from hymls_tpu_torch.parallel import launch
    from hymls_tpu_torch.tools import dist_cases

    t0 = time.perf_counter()
    out = launch.run(dist_cases.phases25_26, DIST_RANKS, backend="gloo",
                     device=str(device), timeout_s=900)
    t_run = time.perf_counter() - t0
    r0 = out[0]
    log(f"distributed: {DIST_RANKS} ranks on {r0['device']} over "
        f"{r0['backend']} (host staging) in {t_run:.1f} s")

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"distributed: {what}")

    rec = {"ranks": DIST_RANKS, "backend": "gloo", "run_s": t_run}
    for part, tag, anchor, slack in (
            ("a", "cavity64 IR newton_step", ANCHOR_DIST_CAVITY64, 2),
            ("b", "stokes128_L2 IR newton_step", ANCHOR_DIST_STOKES128,
             STOKES128_BAND * ANCHOR_STOKES128)):
        d, rep = r0[part]["dist"], r0[part]["rep"]
        log(f"distributed {tag}: inner f32 iterations {d['iters']} "
            f"(replicated on the card {rep['iters']}, JAX CPU at "
            f"{DIST_RANKS} devices {anchor}), true f64 relres "
            f"{d['relres']:.3e} (replicated {rep['relres']:.3e}); "
            f"{d['s']:.3f} s against {rep['s']:.3f} s replicated "
            f"({DIST_RANKS} ranks sharing one H100 over gloo host "
            f"staging; not a scaling number)")
        for o in out:
            check(o[part]["dist"]["dist_active"] and
                  o[part]["dist"]["dcompute"],
                  f"{tag}: the distributed path (and factorization) did "
                  f"not run on rank {o['rank']}")
            check(o[part]["dist"]["iters"] == d["iters"],
                  f"{tag}: ranks disagree on the iterations")
        check(d["shape"] == rep["shape"] and d["finite"] and
              d["dtype"] == "torch.float64", f"{tag}: malformed solution")
        check(d["relres"] <= RELRES_OK, f"{tag}: relres {d['relres']:.3e}")
        if part == "a":
            check(abs(d["iters"] - rep["iters"]) <= 2 and
                  abs(d["iters"] - anchor) <= 2,
                  f"{tag}: {d['iters']} inner iterations")
        else:
            check(abs(d["iters"] - ANCHOR_STOKES128) <= slack,
                  f"{tag}: {d['iters']} inner iterations, not within "
                  f"{STOKES128_BAND:.0%} of {ANCHOR_STOKES128}")
        rec[part] = {"dist": d, "rep": rep, "jax_cpu": anchor}

    c_tol = {"gmres_cavity64": ("relres", RELRES_OK),
             "bordered_cavity64": ("relres", RELRES_OK),
             "deflated_aniso128": ("relres", 5e-9),
             "complex128": ("error", 1e-8)}
    for name, (key, tol) in c_tol.items():
        d, rep = r0["c"]["dist"][name], r0["c"]["rep"][name]
        log(f"distributed f64 {name}: {d['iters']} iterations (replicated "
            f"on the card {rep['iters']}), {key} {d[key]:.3e}")
        for o in out:
            check(o["c"]["dist"][name]["dist"],
                  f"{name}: not distributed on rank {o['rank']}")
        check(abs(d["iters"] - rep["iters"]) <= 1 and d[key] <= tol,
              f"{name}: {d['iters']} iterations (replicated "
              f"{rep['iters']}), {key} {d[key]:.3e}")
        if name == "bordered_cavity64":
            check(d["border_coeff"] <= 1e-8, f"{name}: border coefficients "
                  f"{d['border_coeff']:.3e}")
    rec["c"] = r0["c"]

    for h in r0["d"]:
        pa = h["per_apply"]
        log(f"distributed {h['name']} f64: halo V-cycle vs replicated "
            f"generic apply max rel {h['apply_rel']:.3e} (exactly equal "
            f"{h['apply_exact']}; CUDA scatter-add and reduction orders "
            f"need not match); distributed vs replicated factors max rel "
            f"{h['factor_rel']:.3e} (exactly equal {h['factor_exact']}); "
            f"per apply on rank 0: ppermute {pa['ppermute']['calls']} "
            f"calls {pa['ppermute']['bytes']} B, all_gather "
            f"{pa['all_gather']['calls']} call "
            f"{pa['all_gather']['bytes']} B, psum {pa['psum']['calls']}; "
            f"factorization: all_gather "
            f"{h['compute_collectives']['all_gather']['calls']} call "
            f"{h['compute_collectives']['all_gather']['bytes']} B, "
            f"ppermute {h['compute_collectives']['ppermute']['calls']} "
            f"calls {h['compute_collectives']['ppermute']['bytes']} B")
        check(h["apply_rel"] <= 1e-12 and h["factor_rel"] <= 1e-12,
              f"{h['name']}: halo apply {h['apply_rel']:.3e}, factors "
              f"{h['factor_rel']:.3e}")
        check(pa["all_gather"]["calls"] == 1 and pa["psum"]["calls"] == 0,
              f"{h['name']}: {pa['all_gather']['calls']} all_gathers and "
              f"{pa['psum']['calls']} psums in one apply")
    rec["d"] = [{k: v for k, v in h.items()} for h in r0["d"]]

    launches = 0
    for name, e in r0["e"].items():
        tol = 1e-6 if name.endswith("f32") else 1e-13
        per_rank = [o["e"][name]["launches"] for o in out]
        launches += sum(per_rank)
        log(f"distributed halo DIA {name}: n={e['n']} bands={e['bands']} "
            f"max rel {e['rel']:.3e} against K @ x; dia_spmv launches per "
            f"rank {per_rank}")
        check(e["rel"] <= tol, f"halo DIA {name}: {e['rel']:.3e}")
        check(all(n > 0 for n in per_rank),
              f"halo DIA {name}: a rank never launched dia_spmv")
    rec["e"] = r0["e"]
    rec["halo_dia_launches"] = launches

    nc = launch.run(dist_cases.nccl_single, 1, backend="nccl",
                    device=str(device), timeout_s=300)[0]
    check(nc["ppermute"] == nc["x"] and nc["psum"] == nc["x"] and
          nc["all_gather"] == nc["x"] and nc["devices"] == [str(device)],
          f"NCCL world size 1: {nc}")
    counts = {k: v for k, v in nc["counters"].items()
              if k != "ppermute_words"}
    log(f"NCCL world size 1 on {device}: ppermute (to itself, a local "
        f"copy), psum and all_gather on device tensors agree; counters "
        f"{counts}; multi-rank NCCL needs two or more cards and did not "
        f"run here")
    rec["nccl_world1"] = nc["counters"]
    rec["total_s"] = time.perf_counter() - t0
    log(f"phase 25 in {rec['total_s']:.1f} s")
    rec["sharded"] = check_sharded([o["26"] for o in out], rec["a"]["dist"])
    return rec


def check_sharded(out, halo):
    """Phase 26's gates (module docstring) on every rank's record of
    dist_cases.phase26; `halo` is phase 25's distributed cavity64 step,
    whose time is printed beside the sharded one's."""
    def check(ok, what):
        if not ok:
            raise RuntimeError(f"sharded structured: {what}")

    r0 = out[0]
    rec = {}
    for part, tag, anchor, slack in (
            ("a", "cavity64 IR newton_step", ANCHOR_SHARDED_CAVITY64, 2),
            ("b", "stokes128_L2 IR newton_step", ANCHOR_SHARDED_STOKES128,
             STOKES128_BAND * ANCHOR_STOKES128)):
        d, rep = r0[part]["dist"], r0[part]["rep"]
        per_rank = [o[part]["dist"]["launches"] for o in out]
        log(f"sharded structured {tag}: inner f32 iterations {d['iters']} "
            f"(replicated structured on the card {rep['iters']}, JAX CPU at "
            f"{DIST_RANKS} devices {anchor}), true f64 relres "
            f"{d['relres']:.3e} (replicated {rep['relres']:.3e}); "
            f"{d['s']:.3f} s against {rep['s']:.3f} s replicated"
            + (f" and {halo['s']:.3f} s on the halo V-cycle (phase 25)"
               if part == "a" else "")
            + f" ({DIST_RANKS} ranks sharing one H100 over gloo host "
            f"staging; not a scaling number); dia_spmv launches per rank "
            f"{per_rank}")
        for o in out:
            od = o[part]["dist"]
            check(od["sharded"] and not od["dist_active"] and
                  od["structured"], f"{tag}: rank {o['rank']} did not run "
                  f"the sharded structured apply")
            check(od["iters"] == d["iters"],
                  f"{tag}: ranks disagree on the iterations")
            check(od["launches"] > 0,
                  f"{tag}: rank {o['rank']} never launched dia_spmv")
        check(rep["structured"], f"{tag}: the replicated step is not on the "
              f"structured apply")
        check(d["shape"] == rep["shape"] and d["finite"] and
              d["dtype"] == "torch.float64", f"{tag}: malformed solution")
        check(d["relres"] <= RELRES_OK, f"{tag}: relres {d['relres']:.3e}")
        if part == "a":
            check(abs(d["iters"] - rep["iters"]) <= 2 and
                  abs(d["iters"] - anchor) <= 2,
                  f"{tag}: {d['iters']} inner iterations")
        else:
            check(abs(d["iters"] - anchor) <= slack,
                  f"{tag}: {d['iters']} inner iterations, not within "
                  f"{STOKES128_BAND:.0%} of {anchor}")
        rec[part] = {"dist": d, "rep": rep, "jax_cpu": anchor,
                     "launches_per_rank": per_rank}
    for i, c in enumerate(r0["c"]):
        pa = c["per_apply"]
        log(f"sharded structured {c['name']} f64: sharded apply vs "
            f"replicated structured apply max rel {c['apply_rel']:.3e} "
            f"(exactly equal {c['apply_exact']}); slabs (axis, sizes) per "
            f"level {c['slabs']}; per apply on rank 0: ppermute "
            f"{pa['ppermute']['calls']} calls {pa['ppermute']['bytes']} B, "
            f"all_gather {pa['all_gather']['calls']} calls "
            f"{pa['all_gather']['bytes']} B, psum {pa['psum']['calls']} "
            f"(design {c['design']})")
        check(c["active"], f"{c['name']}: no structured program")
        check(c["apply_rel"] <= 1e-12,
              f"{c['name']}: sharded apply {c['apply_rel']:.3e}")
        for o in out:
            oc = o["c"][i]
            check(all(oc["per_apply"][p] == oc["design"][p]
                      for p in ("ppermute", "all_gather")) and
                  oc["per_apply"]["psum"]["calls"] == 0,
                  f"{c['name']}: rank {o['rank']}'s collectives "
                  f"{oc['per_apply']} are not the design's {oc['design']}")
            check(oc["design"]["ppermute"]["calls"] > 0,
                  f"{c['name']}: no level is sharded")
    rec["c"] = r0["c"]
    rec["launches"] = sum(sum(r["launches_per_rank"])
                          for r in (rec["a"], rec["b"]))
    rec["phase_s"] = r0["s"]
    log(f"phase 26 in {r0['s']:.1f} s (inside phase 25's spawn)")
    return rec


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="an earlier tree of this repository (for example "
                         "a git archive of the parent commit): its "
                         "csrc/dia_spmv.cu is built and timed beside the "
                         "kernel at every sweep shape")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    # every plan build is a cold one, except phase 24's load of what
    # phase 17 stored (each into one fresh temporary directory)
    os.environ["HYMLS_PLAN_CACHE"] = ""
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
    from hymls_tpu_torch.ops.dense_matvec import dense_matvec
    from hymls_tpu_torch.ops.gather import sentinel_gather
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32

    # -- 2. build -------------------------------------------------------------
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    base_build = build_baseline(args.baseline) if args.baseline else None
    _build.build(sources)
    for name in sources:
        _build.load(name)
    if base_build:
        from hymls_tpu_torch.tools.dia_spmv_sweep import load_build
        baseline = load_build(*base_build)
    else:
        baseline = None
    log(f"build: {sources}{' and the baseline dia_spmv' if baseline else ''}"
        f" in {time.perf_counter() - t0:.2f} s")
    spills = []
    for name in _build.BUILD_LOG:
        for fn, (regs, st, ld) in _build.ptxas_report(name).items():
            log(f"  {name}: {fn}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
            if st or ld:
                spills.append(fn)
    log(f"build: kernel instances that spill: {spills or 'none'}")

    # -- 3. kernels against their plain versions ----------------------------
    dia = check_dia_kernel(device, baseline)
    dia_solver_err = check_dia_solver_shapes(device)
    matmat = check_dia_matmat(device, baseline)
    mv = check_dense_matvec(device)
    gather = check_gather(device)

    # -- 4. probe path ----------------------------------------------------------
    reset_counts()
    probe, probe_big, _ = drive_probe(device)
    torch.cuda.synchronize()
    mv_launches = dense_matvec.launches
    log(f"probe path: dense_matvec launches {mv_launches} (wrapper calls "
        f"during graph capture and warm-up; replays are not counted)")
    if mv_launches <= 0:
        raise RuntimeError("the probe path never launched the dense_matvec "
                           "kernel")

    # -- 5. main path: structured apply ("Auto") -----------------------------
    K, b, S, launches, gathers_st = check_main_path(device, "Auto",
                                                    "structured")
    shape, cres = coarse_inverse_residual(S.precond)
    log(f"coarse f32{list(shape)} inverse: max|I - A X| = {cres:.3e}")

    # -- 6. generic apply -------------------------------------------------------
    _, _, Sg, launches_gen, gathers_gen = check_main_path(device, False,
                                                          "generic")

    # -- 7. times -------------------------------------------------------------
    times = time_paths({"structured": S, "generic": Sg}, b, rounds=2)
    scalar = torch.ones((), device=device)
    reads = []
    for _ in range(50):
        t0 = time.perf_counter()
        float(scalar)
        reads.append(time.perf_counter() - t0)
    log(f"host scalar read {statistics.median(reads) * 1e6:.1f} us "
        f"(median of 50)")

    # -- 8. warm Newton sequence, both applies ----------------------------------
    warm, warm_launches = {}, {}
    for structured, tag in (("Auto", "structured"), (False, "generic")):
        reset_counts()
        Sw, Kw, bw, per_step = drive_warm_sequence(device, structured, tag)
        warm[tag] = Sw
        warm_launches[tag] = per_step
    warm_times = time_warm(warm, Kw, bw, rounds=3)
    del warm, Sw

    # -- 9. bordered f64 solve ----------------------------------------------------
    reset_counts()
    bordered, again = drive_bordered(device)
    bordered["compute_solve_s"] = wall_median(again, 3)[0]
    log(f"bordered compute + solve {bordered['compute_solve_s']:.4f} s "
        f"(median of 3, wall clock)")
    del again

    # -- 10. continuation through the fold -------------------------------------
    reset_counts()
    cont = drive_continuation(device)

    # -- 11. stokesB_64: L = 2, no dropping, generic apply ----------------------
    _, stokesB = drive_newton_case(
        device, "stokesB_64", stokesB64_case(), ANCHOR_STOKESB,
        structured=False, reason="Apply Dropping == false")

    # -- 12. stokes128_L2 on the default apply ------------------------------------
    _, stokes128 = drive_newton_case(
        device, "stokes128_L2", stokes128_case(), ANCHOR_STOKES128,
        structured=True, slack=STOKES128_BAND * ANCHOR_STOKES128)

    # -- 13. restarted GMRES ------------------------------------------------------
    restart = drive_restart(device)

    # -- 14. direct Schur ---------------------------------------------------------
    direct = drive_direct(device)

    # -- 15. B-grid transform -----------------------------------------------------
    bgrid = drive_bgrid(device)

    # -- 16. 'Factor Precision' f64 -----------------------------------------------
    factor64 = drive_factor_precision(device, S)

    # -- 17. stokes32cube_skew_L2 (its plans stored for phase 24) ------------
    cache_dir = tempfile.mkdtemp(prefix="hymls_plan_cache_")
    try:
        with plan_cache(cache_dir):
            stokes32 = drive_stokes32cube(device)

        # -- 18. deflated solve ----------------------------------------------
        deflated = drive_deflated_aniso(device)

        # -- 19. bordered + deflated -----------------------------------------
        bordered_deflated = drive_bordered_deflated(device)

        # -- 20. complex solves ----------------------------------------------
        cplx = drive_complex(device)

        # -- 21. eigenvalues -------------------------------------------------
        eigen = drive_eigen(device)

        # -- 22. the driver --------------------------------------------------
        driver = drive_driver(device)

        # -- 23. the MATLAB bridge -------------------------------------------
        bridge = drive_bridge(device)

        # -- 24. the plan disk cache -----------------------------------------
        cached = drive_plan_cache(device, cache_dir, stokes32)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)

    # -- 25-26. distributed: 4 ranks on the card over gloo (the halo
    # V-cycle, then the sharded structured apply), NCCL at size 1 ----------
    reset_counts()
    distributed = drive_distributed(device)

    # -- 27. the config suite through the driver -----------------------------
    suite = drive_suite(device)

    # -- 28. the apply replayed from its CUDA graph --------------------------
    apply_graph = drive_apply_graph(device)

    # -- 29. the large coarse system as its inverse against LU ---------------
    coarse = drive_coarse_inverse(device)

    # -- 30. GMRES's iterations replayed from CUDA graphs against eager ------
    gmres_graph = drive_gmres_graph(device)

    # the card again: a tool that keeps only the end of the output keeps it
    log(f"total {time.perf_counter() - t_start:.1f} s on "
        f"{gpu_name_and_power()}")
    main32 = dia["cavity64"]["f32"]
    sweep = {shape: {tag: {k: r[k] for k in (
        "device_us", "bound_us", "roofline_share", "library_us", "call_us",
        "host_issue_us", "library_call_us", "library_host_issue_us",
        "baseline_device_us", "floor_us",
        "max_rel_err")} for tag, r in recs.items()}
        for shape, recs in dia.items()}
    # the per-phase records on a line of their own: the kernels line
    # below is kept short enough that the last 24 kB of the output hold
    # it whole
    log(json.dumps({"records": {
        "paths": times, "warm": warm_times, "bordered": bordered,
        "continuation": cont, "stokesB_64": stokesB,
        "stokes128_L2": stokes128, "restart": restart, "direct": direct,
        "bgrid": bgrid, "factor_precision": factor64,
        "stokes32cube_skew_L2": stokes32, "deflated": deflated,
        "bordered_deflated": bordered_deflated, "complex": cplx,
        "eigen": eigen, "driver": driver, "bridge": bridge,
        "plan_cache": cached, "distributed": distributed,
        "apply_graph": apply_graph, "coarse_inverse": coarse,
        "gmres_graph": gmres_graph}}))
    mm18 = matmat["timed"][f"aniso{DEFL_NX} B=8 f64"]
    defl_configs = {f"{phase}_{c}": r for phase, recs in (
        ("driver", driver), ("suite", suite["auto"]))
        for c, r in recs.items() if isinstance(r, dict)
        and r.get("deflation_setups")}
    log(json.dumps({"kernels": [{
        "name": "dia_spmv", "route": "cuda",
        "source": "hymls_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "hymls_tpu/ops/pallas_spmv.py:50",
        "launches": launches,
        "launches_by_path": {
            "structured": launches, "generic": launches_gen,
            **{f"warm_{tag}": sum(n) for tag, n in warm_launches.items()},
            "bordered": bordered["launches"],
            "newton_bratu": cont["newton_launches"],
            "continuation": cont["launches"],
            "stokesB_64": stokesB["launches"],
            "stokes128_L2": stokes128["launches"],
            "restart30": restart["launches"],
            "ir_numblocks60": restart["ir_numblocks60"]["launches"],
            **{f"direct_{t}": r["launches"] for t, r in direct.items()},
            **{f"stokes_L2_{t}": r["launches"] for t, r in bgrid.items()},
            **{f"factor_f64_{t.split()[0].lower()}": r["launches"]
               for t, r in factor64.items() if "launches" in r},
            "stokes32cube": stokes32["launches"],
            "stokes32cube_f64": stokes32["f64_launches"],
            "deflated": deflated["launches"],
            "bordered_deflated": bordered_deflated["launches"],
            "complex": cplx["launches"],
            "jdqr": eigen["jdqr"]["launches"],
            "shift_invert": eigen["shift_invert"]["launches"],
            "driver": sum(driver[c]["launches"] for c in ANCHOR_DRIVER),
            **{f"driver_{c}": driver[c]["launches"] for c in ANCHOR_DRIVER},
            "plan_cache_stokes32cube": cached["launches"],
            "halo_dia_4ranks": distributed["halo_dia_launches"],
            "dist_structured": distributed["sharded"]["launches"],
            "suite": sum(r["launches"] for r in suite["auto"].values()),
            **{f"suite_{c}": r["launches"]
               for c, r in suite["auto"].items()}},
        "launches_per": {
            **{f"warm_step_{tag}": n for tag, n in warm_launches.items()},
            "bordered_solve": bordered["launches"],
            "continuation_corrector": cont["launches_per_corrector"],
            "stokesB_64_step": stokesB["launches"],
            "restarted_solve": restart["launches"],
            "bgrid_apply": bgrid["8_bgrid"]["launches_per_apply"],
            "plain_apply": bgrid["8_plain"]["launches_per_apply"],
            "deflation_setup": deflated["setup_launches"],
            "deflated_solve": deflated["solve_launches"],
            "bordered_deflation_setup": bordered_deflated["setup_launches"],
            "bordered_deflated_solve": bordered_deflated["solve_launches"],
            **{f"dist_structured_{t}_step_per_rank":
               distributed["sharded"][p]["launches_per_rank"]
               for p, t in (("a", "cavity64"), ("b", "stokes128_L2"))}},
        "max_abs_err": max(dia_solver_err[0], *(
            r["max_abs_err"] for recs in dia.values()
            for r in recs.values())),
        "max_rel_err": max(dia_solver_err[1], *(
            r["max_rel_err"] for recs in dia.values()
            for r in recs.values())),
        "ms": main32["device_us"] * 1e-3,
        "plain_ms": main32["plain_device_us"] * 1e-3,
        "bound_ms": main32["bound_us"] * 1e-3,
        "bound_by": main32["bound_by"],
        "library_ms": main32["library_us"] * 1e-3,
        "library": "torch.mv on a torch.sparse_csr_tensor (cuSPARSE SpMV)",
        "times_are": "device time per launch by CUDA-graph replay of 100 "
                     "launches, at cavity64 in f32; per shape and type in "
                     "sweep (us)",
        "plain_call_ms": main32["plain_call_us"] * 1e-3,
        "sweep": sweep}, {
        "name": "dense_matvec", "route": "cuda",
        "source": "hymls_tpu_torch/csrc/dense_matvec.cu",
        "replaces": "tools/loop_pathology_bench.py:59",
        "launches": mv_launches,
        "launches_are": "wrapper calls during CUDA-graph capture and "
                        "warm-up; graph replays are not counted",
        "max_abs_err": mv["max_abs_err"], "max_rel_err": mv["max_rel_err"],
        "ms": mv[2048]["device_us"] * 1e-3,
        "plain_ms": mv[2048]["plain_device_us"] * 1e-3,
        "bound_ms": mv[2048]["bound_us"] * 1e-3, "bound_by": "bytes",
        "library_ms": mv[2048]["plain_device_us"] * 1e-3,
        "library": "torch.matmul (cuBLAS), which is also the plain version",
        "times_are": "device time per launch by CUDA-graph replay of 100 "
                     "launches at n = 2048; call_ms_* with host issue",
        "bound_us": {str(n): mv[n]["bound_us"] for n in (2048, 8192)},
        "device_us_n8192": mv[8192]["device_us"],
        "plain_device_us_n8192": mv[8192]["plain_device_us"],
        **{f"call_ms_n{n}": mv[n]["ms"] for n in MV_SIZES},
        **{f"plain_call_ms_n{n}": mv[n]["plain_ms"] for n in MV_SIZES},
        "probe_ms_per_iter": probe,
        "probe_ms_per_iter_n8192": probe_big}, {
        "name": "sentinel_gather", "route": "cuda",
        "source": "hymls_tpu_torch/csrc/gather.cu",
        "replaces": None,
        "replaces_what": "no TPU kernel: the generic apply's "
                         "torch.cat([v, 0])[idx] (fill, copy, index)",
        "launches": gathers_gen["solve"],
        "launches_by_path": {"structured": gathers_st["solve"],
                             "generic": gathers_gen["solve"]},
        "factorization_launches_by_path": {
            "structured": gathers_st["factorize"],
            "generic": gathers_gen["factorize"]},
        "launches_are": "wrapper calls in the cavity64 Newton step's "
                        "solve (phases 5-6), at capture, warm-up and "
                        "eager calls; graph replays are not counted",
        "launches_per": {
            f"generic_apply_{k}": v
            for k, v in gather["per_apply"].items()},
        "fields_held": gather["fields_held"],
        "block_apply_rel_err": gather["block_apply_rel_err"],
        "bound_by": "bytes",
        "times_are": "device time per launch by CUDA-graph replay of 100 "
                     "launches in f32, at level 0 of the benchmark's 3-D "
                     "and THCM plans (us)",
        "sweep": gather["timed"]}, {
        "name": "dia_matmat", "route": "cuda",
        "source": "hymls_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "hymls_tpu/ops/pallas_spmv.py:104",
        "replaces_what": "PallasDiaMatvec under jax.vmap (the batched "
                         "deflation setup, hymls_tpu/ops/spmv.py:170)",
        "launches": deflated["matmat_launches"],
        "launches_by_path": {
            "deflated": deflated["matmat_launches"],
            "bordered_deflated": bordered_deflated["matmat_launches"],
            **{c: r["matmat_launches"] for c, r in defl_configs.items()}},
        "k1_launches_in_setups": {
            "deflated": deflated["setup_launches"],
            "bordered_deflated": bordered_deflated["setup_launches"],
            **{c: sum(d["k1_launches"] for d in r["deflation_setups"])
               for c, r in defl_configs.items()}},
        "setup_s": {
            "deflated": [deflated["setup_s"], deflated["subspace_s"],
                         deflated["projected_solves_s"]],
            "bordered_deflated": [bordered_deflated["setup_s"],
                                  bordered_deflated["subspace_s"],
                                  bordered_deflated["projected_solves_s"]],
            **{c: [[d["setup_s"], d["subspace_s"], d["projected_solves_s"]]
                   for d in r["deflation_setups"]]
               for c, r in defl_configs.items()}},
        "setup_s_are": "[setup, subspace iteration, projected solves] s, "
                       "wall clock",
        "max_abs_err": matmat["max_abs_err"],
        "err_ulp_of_sum_abs_terms": {"f64": matmat["f64_err_ulp"],
                                     "f32": matmat["f32_err_ulp"]},
        "ms": mm18["device_us"] * 1e-3, "plain_ms": mm18["plain_us"] * 1e-3,
        "bound_ms": mm18["bound_us"] * 1e-3, "bound_by": mm18["bound_by"],
        "library_ms": mm18["library_us"] * 1e-3,
        "k1_rows_ms": mm18["k1_rows_us"] * 1e-3,
        "baseline_ms": (mm18["baseline_us"] * 1e-3
                        if mm18["baseline_us"] is not None else None),
        "instances_run": matmat["instances"],
        "instances_that_spill": [f for f in spills if "spmm" in f],
        "us_per_added_vector": matmat["us_per_added_vector"],
        "library": "torch.sparse.mm on a torch.sparse_csr_tensor (cuSPARSE "
                   "SpMM)",
        "times_are": f"device time per launch by CUDA-graph replay of 100 "
                     f"launches, aniso{DEFL_NX} (phase 18) B = 8 in f64; "
                     f"per shape, B and type in sweep (us)",
        "sweep": {k: {f: r[f] for f in (
            "device_us", "baseline_us", "bound_us", "floor_us",
            "k1_rows_us", "plain_us", "library_us")}
            for k, r in matmat["timed"].items()}
        }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
