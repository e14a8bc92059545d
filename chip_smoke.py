#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its seconds and numbers; any failed gate raises, so
the script exits non-zero and prints no result line):

1. device and build: ``nvidia-smi`` name and power limit, then the nvcc
   build of every kernel in ``slam_tpu_torch/csrc`` (one nvcc per source,
   all started together);
2. each kernel against its plain PyTorch version on the card, in float32
   and float64:
   - every gather and scatter launch of one LM iteration of INTEL+50 and
     M10000+50 (real poses and edges), of INTEL+50 under method 2 on
     the Schur, dense and PCG solvers, and of the sphere2500 recipe
     (SE(3), D = 6) under the native and the blocked Schur
     factorisation, recorded and replayed: each
     gather bitwise equal to ``index_select``; each grouped scatter
     launch bitwise equal to itself run again and to its groups launched
     one at a time, and within TOL of its plain version;
   - the linearisation at the same shapes: the solver's indexed entry
     (the kernel reads the endpoints itself) and the JAX-shaped entry on
     gathered inputs, each within TOL of its plain version and the two
     bitwise equal;
   - the short solves of methods 3 and 4 on INTEL+50 and CSAIL+50, as a
     manager run cut to its first ``MANAGER_KERNEL_CANDIDATES`` closures
     gives them: a candidate's edge mask (odometry, a layer's closures
     and the new one) and a free mask that holds every node outside one
     window (method 3's commit window, method 4's nodes of the active
     edges), each one LM iteration on the pose-only dense plan recorded
     and replayed as above, and the linearisation on those masks within
     TOL of its plain version;
   - the same on the fused method-3 engine's own inputs, on its Schur
     plan, at INTEL+50 and M3500+50 (a run cut to its first
     ``MANAGER_KERNEL_CANDIDATES`` closures): a candidate step's ten
     evaluations folded into one batch (their edge masks, every node but
     node 0 free, on the stacked plan of ten lanes), and a windowed
     commit;
   - ``micro_chol_inv`` on SPD batches of (16, 128, 128) and
     (32, 128, 128), of 48, 80, 96 and 128 such panels (past 33 panels
     the split schedule: the factor, then the inverse in a second
     launch; 96 is the rescue's chain batch, 6 chains x 16 interiors,
     128 the seed batch's, 8 seeds x 16), and on real panels: the first
     and the trailing diagonal panel of the equilibrated Schur interiors
     of INTEL+50, M10000+50 and the sphere2500 recipe (D = 6, D ni =
     3450) at their initial poses, lambda = 1e-4;
     ``micro_chol_inv_folded`` on the (6, 16, 128, 128) and
     (8, 16, 128, 128) views of the 96 and 128 SPD panels and on the seed
     batch's real first and trailing panels folded over its 8 seeds, in
     float32 and float64; L bitwise equal to the plain version's of the
     flat batch, the inverse within TOL (SPD) or RESID_FACTOR (real
     panels);
   - the DCS rescue's chain batch (``tools/problems.intel50_chains``: the
     first consensus round of ``INTEL 50 1 --seed 42``, its six chains'
     masks on six copies of the problem, 9216 edges over 7368 nodes): one
     batched LM iteration on the Schur solver (96 interiors, 6
     separators; in float32 also blocked, with the kernel) and on the
     dense solver (six 3684 x 3684 matrices) recorded and replayed as
     above, the linearisation on the chains' masks held to its plain
     version; ``micro_chol_inv_folded`` on the chain batch's real first
     and trailing panels folded over its six chains (float32 and
     float64); one batched iteration
     of that chain batch, and of the INTEL+50 seed batch of seeds 0-7, on
     PCG (3 CG iterations) and on the Woodbury solver, recorded and
     replayed as above;
   - the joint-SC seed batch of phase 6i: one batched iteration on the
     Schur solver (native; in float32 also blocked, with the kernel) and
     on the dense joint solver (eight 5220 x 5220 systems) recorded and
     replayed as above, the fused linearisation not launched; and
     ``micro_chol_inv_folded`` on the real first and trailing panels of
     its interiors with the switches eliminated, after
     ``SC_PANEL_ITERS`` iterations, folded over its 8 seeds;
   - ``stack_cholesky`` (``[stack_chol]``) on the stacks of
     ``STACK_CHOL_SHAPES`` (the dense cell's eight 5217^2 joint systems,
     the Schur separators of M3500+50, of the M3500 seed batch and of
     INTEL), scaled as the dense solver scales them, float32 and
     float64: every lane factored, the launch count, zeros above the
     diagonal, the residual max|L L^T - H| within RESID_FACTOR of the
     cuSOLVER loop's, the first and last lanes equal to their matrices
     alone to the bit; timed in phase 12 against its bound, its plain
     version (with the scale) and the cuSOLVER loop (``library_ms``);
3. the main path through the CLI, ``INTEL 50 1 --seed 42`` (auto init,
   auto solver = Schur, rescue on, float32): the output files, the launch
   count of every kernel during that run, and the ATE against the golden
   trajectory;
4. plain DCS on INTEL+50 (no rescue), 50 ``lm_fixed_iters`` iterations,
   held against the float64 JAX reference cost in
   ``slam_tpu_torch/data/reference_costs.json``, with its launches per
   iteration;
5. scale: M10000+50, dataset init, auto partition, 50 ``lm_fixed_iters``
   iterations in one call: cost <= 0.8 x initial, and LM iterations/s;
6. the blocked Schur path (``schur_blocked``, panel 128,
   ``schur_pallas_micro``), float32: (a) ``INTEL 50 1 --seed 42`` through
   ``run_from_config`` with its launch counts and ATE; (b) plain DCS
   against the float64 reference under the blocked path's gate; (c)
   M10000+50, cost <= 0.8 x initial; (d) LM iterations/s of (b) and (c)
   under the native, blocked-plain-panel and blocked-kernel
   configurations, in turns; native INTEL within ``LAUNCH_LIMITS``;
6e. ``seed_batch``: the per-seed batch of ``bench.py``'s INTEL row
   (``tools/problems.intel50_seed_batch``: INTEL+50 of seeds 0-7, plain
   DCS, Schur with 16 index blocks padded to the seeds' maxima, float32),
   ``BATCH_ITERS`` (50) iterations of ``solver/batch.lm_fixed_iters_batch``
   under the native, blocked-plain-panel and blocked-kernel
   factorisations, and each seed alone through ``lm_fixed_iters`` on its
   share of the batch's shapes, in turns (batch, seeds, seeds, batch):
   every seed of the batch meets ``bench.py``'s gate (initial cost > 2,
   cost < 0.6 x initial) and lands within ``SEED_BATCH_F32_RTOL`` of its
   float64 batch cost, and the batch launches each kernel as often as
   one seed's run; each seed of the batch is held to its run alone in
   float32 after one iteration (all three factorisations) and in float64
   after all of them (native, blocked-plain), at ``SEED_BATCH_*``; the
   float32 differences from the runs alone after 50 iterations and
   whether they are equal to the bit are printed, not gated; with the
   batch's wall, LM iterations/s as ``bench.py`` reckons them (B x
   iterations / wall), the eight seeds' total wall, the peak of
   ``torch.cuda.max_memory_allocated`` above what is held before, and
   (with the kernels' times, under torch.profiler) device ms and busy
   share per batched iteration;
6f. ``rescue_batch``: the DCS rescue's consensus rounds as one batched
   ``lm_solve`` (``solver/batch.lm_solve_batch`` over the chains):
   (a) float64, the first round of ``INTEL 50 1 --seed 42`` (its six
   chains' masks as the rescue builds them from the plain solve): each
   lane of the batched solve held to ``lm_solve`` of its chain alone
   within ``RESCUE_F64_RTOL`` in cost and ``RESCUE_F64_POSE_ATOL`` in
   poses, with equal iterations, accepted steps and convergence; the
   launches of one batched iteration equal to one chain's and within
   ``LAUNCH_LIMITS``; (b) the rounds of phases 3 and 6a (the lanes
   and the batched iterations of each round) and their solves' wall; (c) ``INTEL 50 1 --seed 42 --linear-solver dense`` through the
   CLI (the chains on the batched dense solver), float32: ATE below
   ``ATE_GATE_M``, its rounds, wall and peak allocated memory; (d) the
   first round's float32 batched solve on the Schur solver (native, and
   blocked with ``micro_chol_inv``: its 96 folded panels) and on the
   dense solver: wall and launches per batched iteration, and (with the
   kernels' times, under torch.profiler) device ms and busy share;
6g. ``pcg_batch``: the batched PCG (``linear.pcg_solve(seeds=)``, each
   lane its own CG scalars and stopping test): (a) float64, the rescue's
   first round (the six chains under the masks the Schur rescue builds)
   on PCG, ``lm_solve_batch`` capped at ``PCG_ROUND_ITERS`` LM
   iterations, and the chains alone one after another, in turns: each
   lane within ``RESCUE_F64_RTOL`` in cost and ``RESCUE_F64_POSE_ATOL``
   in poses of its chain alone, with equal iterations, accepted steps,
   convergence and CG counts; the launches of a batched iteration equal
   to one chain's (every CG run to ``PCG_FIXED_CG``), at most
   ``PCG_LAUNCH_LIMIT`` gathers and scatters an iteration of the CG loop
   (those it runs after its lanes stopped and before its next host check
   included), and the slowest lane's, the lanes' and the loop's CG
   iterations printed; (b) float32,
   ``scripts/bench_pcg.py``'s batch (INTEL+50 x seeds 0-7, the
   tridiagonal preconditioner, rtol 1e-6, 100 CG iterations,
   ``BATCH_ITERS`` LM iterations): every seed meets its gate (initial
   cost > 2, final < 0.6 x initial); CG iterations per seed, ms per
   iteration of the CG loop, peak allocated memory, and LM it/s of the batch
   against ``LANE_ALONE_SEEDS`` seeds alone over ``LANE_TIMED_ITERS``
   iterations, in turns (device ms and busy share a batched iteration
   with the kernels' times, on PCG of one LM iteration cut to
   ``PCG_PROFILE_CG`` CG iterations); (c) the managers' PCG eval folded: the
   float64 fused runs of methods 3 and 4 cut to ``PCG_FOLD_CANDIDATES``
   closures, the last batch of each width (10; 3 and 2) held as phase
   10d (a) holds the Schur and dense evals; M3500+50 method 4 on the
   host engine (PCG eval above 2048 nodes) cut to
   ``HOST_PCG_CANDIDATES`` closures: wall, calls and solves per
   candidate;
6h. ``woodbury_batch``: the batched Woodbury solver
   (``build_woodbury_ops(seeds=)``): (a) as 6g (a), to convergence; (b)
   as 6g (b) on ``scripts/bench_woodbury.py``'s batch (each seed's
   low-rank edges padded to the seeds' largest count), its gate printed,
   not raised (the float32 correction cancels; (a) holds it in float64);
6i. ``sc_batch``: joint switchable constraints (method 2) in the seed
   batch (``tools/problems.intel50_seed_batch(..., "sc")``: INTEL+50 of
   seeds 0-7) on the Schur solver (native and blocked with the kernel),
   the dense joint solver, Woodbury and PCG (rtol 1e-8, 250 CG
   iterations, ``SC_PCG_ITERS`` LM iterations): (a) float64, each seed
   of the batch held to its run alone over ``SC_BATCH_F64_ITERS``
   iterations at the seed batch's float64 gates, switches included,
   accepted steps and CG iterations equal; (b) float32, the same after
   one iteration at the first-iteration gates (the blocked-kernel run at
   ``SC_BATCH_STEP_TOL``), and the launches of a batched iteration equal
   to one seed's (``micro_chol_inv`` on the blocked-kernel run,
   ``fused_linearize_se2`` on none: joint SC takes the plain
   linearisation); (c) float32: every seed meets ``bench.py``'s gate and
   lands within ``SC_BATCH_F32_RTOL`` of its float64 batch cost, PCG at
   most ``PCG_LAUNCH_LIMIT`` gathers and scatters an iteration of the CG
   loop; the
   batch's wall, LM it/s and peak allocated memory against the seeds
   alone (PCG: ``LANE_ALONE_SEEDS``) in turns (batch, seeds, seeds,
   batch), and (with the kernels' times) device ms and busy share per
   batched iteration of Schur native and dense;
7. method 2 (switchable constraints), float32:
   (a) ``method2_path``: ``INTEL 50 2 --seed 42`` through the CLI (auto
   solver = Schur with the switches eliminated), and again with
   ``--sc-varpro``: ``switches.txt`` in the reference's layout, the final
   cost against the float64 JAX run's and its count of loop switches
   below 0.5, the launches per LM iteration;
   (b) ``method2_dense``: joint SC on the dense joint system, 50
   ``lm_fixed_iters`` against the float64 reference;
   (c) ``method2_ab``: joint SC on INTEL+50 (against the reference) and
   M10000+50 (cost <= 0.8 x initial), 50 ``lm_fixed_iters`` under the
   native, blocked-plain-panel and blocked-kernel factorisations, LM
   iterations/s in turns; native INTEL within ``M2_LAUNCH_LIMITS``;
   (d) ``pcg``: plain DCS and joint SC on PCG (tridiagonal
   preconditioner), 10 ``lm_fixed_iters`` each against the float64
   reference, with the CG iterations and the launches per CG iteration
   (at most ``PCG_LAUNCH_LIMIT`` gathers and scatters);
   (e) ``report_stages``: the method-2 CLI with ``--report-stages``,
   three positive, finite stage times;
8. SE(3) and the golden cells, float32:
   (a) ``se3_path``: ``sphere2500 50 1 --seed 0`` through the CLI (auto
   init, auto solver = Schur, 2 index blocks): ATE against the golden
   trajectory below ``SE3_ATE_GATE_M``, wall seconds, iterations and
   launches;
   (b) ``se3_ab``: the sphere2500 recipe of ``bench.py``'s sphere row (20
   corrupted closures, plain DCS, Schur with 4 index blocks, 30
   ``lm_fixed_iters``) under the native, blocked-plain-panel and
   blocked-kernel factorisations, in turns, each final cost against its
   float64 JAX reference within ``SE3_REF_COST_RTOL`` and at most
   ``SCALE_COST_FRAC`` x initial; the blocked-kernel run launches
   ``micro_chol_inv``;
   (c) ``golden``: the dense-solver golden cells of
   ``tests/test_golden.py`` (CSAIL clean, CSAIL+50 seed 42 DCS, INTEL
   clean; 40 iterations of ``lm_solve``) at their ATE and cost bounds;
9. methods 3 and 4 (the layering and MCTS host engines), float32,
   through the CLI, each run's log lines sent to a file and its decision
   stream held to the manager oracle's
   (``slam_tpu_torch/data/manager_decisions.json``,
   ``slam_tpu_torch/tools/manager_spread.py``):
   ``method4_path`` (``INTEL 50 4 --seed 42``: 306/306 decisions and the
   oracle's layer), ``method3_ceres`` (``INTEL 50 3 --seed 42
   --eval-trust-region ceres``: 306/306, the assignments and the layer),
   ``method3_path`` (``INTEL 50 3 --seed 42``, the default Nielsen eval:
   an identical prefix of at least ``M3_NIELSEN_PREFIX``, its first
   divergence printed) and ``csail_managers`` (``CSAIL 50 3`` and ``4``,
   ``--seed 0``: 178/178 each); each prints its wall, its short solves and
   its largest Delta, split-value and residual differences from the
   oracle, gated at ``MANAGER_DIFF_GATES``; these runs pass ``--fused
   off``;
10. methods 3 and 4 on the fused engines (the decision loop on the
   device), float32 unless named, every chunk run under
   ``torch.cuda.set_sync_debug_mode("error")`` (a host read inside a
   chunk fails the run):
   (a) ``fused_managers``: the five cells of phase 9 through the CLI with
   ``--fused on`` and the default (Schur) eval, held to the oracle's
   streams as phase 9 holds the host engines, gated at
   ``FUSED_MANAGER_DIFF_GATES``; then the PCG eval, the stated exception,
   on INTEL+50 method 4 cut to ``FUSED_PCG_CANDIDATES`` closures, with its
   calls and host reads per candidate (fewer than
   ``FUSED_PCG_LOOPED_READS``, the parent's one call an evaluation);
   (b) ``fused_vs_host``: ``CSAIL 50 4 --seed 0`` in float64 with the
   dense eval on the fused and the host engine: the same assignments,
   layers and chosen layers, poses within ``FUSED_VS_HOST_ATOL``;
   (c) ``fused_m3500``: ``M3500 50 4 --seed 0`` on the fused engine,
   whole: every closure decided, finite poses, and its layers, chosen
   layers and ATE beside the JAX float32 record
   (``results/layer_tables/M3500_50out_s0_m4.json``), not gated;
   (d) ``manager_fold``: the candidate evaluations folded into one
   batched short solve (``solver/batch.lm_fixed_iters_candidates``):
   in float64 on INTEL+50 seed 42, on the Schur and the dense eval, the
   last folded batch of each width of a fused run cut to
   ``FOLD_CANDIDATES`` closures (a layering step's ten evaluations, a
   MCTS step's split check of three and reward of two), each lane held
   to its solve alone within ``FOLD_F64_RTOL`` in cost and
   ``FOLD_F64_POSE_ATOL`` in poses, and the launches of one batched
   iteration equal to one lane's (with the batch's peak allocated
   memory); in float32, the fused engines of
   methods 3 and 4 on that cell cut to ``FOLD_CANDIDATES`` closures,
   folded and with one call per evaluation as before the fold, in turns
   (folded, looped, looped, folded): wall, calls, launches and peak
   allocated memory per candidate, and (under torch.profiler, with the
   kernels' times, on runs cut to ``FOLD_PROFILE_CANDIDATES`` closures
   against their own unprofiled wall) device ms and busy share per
   candidate;
   phases 9 and 10 print each run's ``lm_fixed_iters`` calls beside its
   short solves (a folded batch is one call, each lane one solve);
11. the last modules (Woodbury, sweeps, the distributed solvers,
   profiling):
   (a) ``woodbury_path``: ``INTEL 50 1 --seed 42 --linear-solver woodbury
   --dtype float64`` through the CLI (the rescue's rounds batched, as
   ``[rescue_batch]`` (b) prints them), ATE below ``ATE_GATE_M``; 50
   ``lm_fixed_iters`` of plain DCS on the Woodbury solver in float64,
   within ``WOODBURY_REF_COST_RTOL`` of its float64 JAX reference, and in
   float32, gated on finite output only (its correction cancels);
   (b) ``sweep``: ``INTEL 50 1 --sweep`` (methods 0 and 1, outliers 0,
   10 and 50, seed 0): every row finite, each method-1 row's ATE against
   the clean solve below ``ATE_GATE_M``, and the (1, 50, 0) cell's cost
   and ATE equal to the bit to the same cell run alone;
   (c) ``dist_edge``: ``distributed_lm`` on INTEL+50 seed 42 (plain DCS,
   float64, 5 LM iterations, CG to 1e-10 or 400 iterations) at
   ``DIST_EDGE_RANKS`` ranks sharing the card (gloo), held to the
   single-process block-Jacobi PCG at ``DIST_EDGE_TOL``, every rank's
   poses bitwise equal; then at one rank under nccl; and
   ``init_multihost`` from torchrun's environment in this process: the
   card, nccl, and meshes that carry the card;
   (d) ``dist_schur``: ``slam_tpu_torch/tools/dist_check.py`` (M3500+50,
   ``DIST_SCHUR_RANKS`` ranks sharing the card, gloo, float32,
   contiguous and spectral blocks) under its gates, with the wall and the
   bytes reduced per iteration and the share of the wall in collectives;
   the replica batch of two CSAIL+50 seeds on 2 x 2 ranks (float64),
   each replica within ``BATCH_REL`` of its seed alone on 2 ranks, and
   each seed alone on 2 ranks, the batch, and the first seed on 4 ranks
   (contiguous and spectral) held to the single-process Schur at
   ``DIST_SCHUR_F64_TOL``;
   (e) ``profile``: ``INTEL 50 1 --seed 42 --profile DIR`` in a child
   process: its trace names each kernel's symbol once per launch of
   phase 3's run, and its final cost and poses equal phase 3's to the
   bit;
   phase 2 also replays one Woodbury iteration, one rank's calls of the
   edge-parallel LM and of the distributed Schur LM at these shapes;
12. the kernels' times, after the end-to-end phases and with every
   profiler session last, since one leaves the later host-bound calls of
   its process slower (``[kernels]`` lines, float32; and
   ``micro_chol_inv`` in float64): per launch and per plan of the
   recorded iterations (``micro_chol_inv`` on the real (16, 128, 128)
   INTEL and (32, 128, 128) M10000 batches), and on the SPD batches
   (``micro_chol_inv_folded`` on (6, 16, 128, 128) and (8, 16, 128, 128),
   float32 and float64, with the schedule and the device kernels a
   call):
   the kernel (``ms``: CUDA
   events around 50 back-to-back calls; ``device_ms``: its device events
   under torch.profiler; ``host_us``: host time per call with no sync),
   the plain version, the library call that computes the same function,
   and the kernel's bound on this card
   (``slam_tpu_torch/tools/kernel_times.py``).

Each phase that drives a path names the kernels the path must launch; the
launch counts are set to 0 just before the path and read just after.
After the last phase the script stops the ranks' forkserver and resource
tracker and fails if any process it started is still there.
Then one JSON line of per-kernel results, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances of kernel vs plain version, relative to the largest magnitude
# of each compared tensor (max(1, max|plain|), per output field of the
# linearisation): float64 agrees to rounding;
# float32 trig, FMA contraction and summation order differ in the last
# bits.  The gather is a copy and must be bitwise equal.
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# On real Schur panels (conditioned far worse than the SPD test batches)
# each residual of the kernel, max|L L^T - A| and max|inv L - I|, may be at
# most this factor times the plain version's own on the same panel.
RESID_FACTOR = 2.0
# Main-path gates.
ATE_GATE_M = 0.8          # tests/test_golden.py: rescued vs 4.24 m poisoned
REF_COST_RTOL = 1e-3      # float32 card vs float64 JAX reference (native)
# The blocked path's gate: twice the largest |relative difference| from
# the float64 reference over the float32 runs of the three factorisations,
# from the initial poses and 16 copies perturbed by 1e-7, on the card and
# on the CPU (python -m slam_tpu_torch.tools.f32_spread --perturb 16, and
# --device cpu); PERF.md gives both spreads.  Both reach 1.03e-3.
BLOCKED_REF_COST_RTOL = 2.1e-3
SCALE_COST_FRAC = 0.8     # M10000: cost <= 0.8 x initial
# Method 2's gates and PCG's against the float64 JAX references: each is
# twice the largest |relative difference| of float32 from its reference
# over the initial poses and 16 copies perturbed by 1e-7 (and the three
# Schur factorisations where the path is the Schur solver's), on the card
# and on the CPU (python -m slam_tpu_torch.tools.f32_spread --perturb 16
# --robust R --linear-solver S [--cli], and --device cpu); PERF.md gives
# both.  Keyed by (robust, linear solver, command-line run), the largest
# spread in the comment, card / CPU.
M2_REF_COST_RTOL = {
    ("sc", "schur", True): 1.82e-2,        # 8.16e-3 / 9.09e-3
    ("sc_varpro", "schur", True): 4.06e-2,  # 2.03e-2 / 1.91e-2
    ("sc", "dense", False): 8.62e-3,       # 4.31e-3 / 1.41e-4
    ("sc", "schur", False): 2.71e-2,       # 1.35e-2 / 1.32e-2
    ("dcs", "pcg", False): 2.06e-3,        # 1.03e-3 / 6.86e-4
    ("sc", "pcg", False): 0.102,           # 5.09e-2 / 5.06e-2
}
# Launches per LM iteration of native INTEL joint SC (phase 7c): the
# linearisation gathers both sources and sums its nodes, the elimination
# sums its corrections, the Schur solve gathers and scatters as for DCS,
# the back-substitution gathers.
M2_LAUNCH_LIMITS = {"gather_rows": 7, "scatter_add_rows": 5}
# Gathers and scatters per CG iteration of a PCG run: one each per matvec,
# and a few per LM iteration outside the CG loop.
PCG_LAUNCH_LIMIT = 1.05
# SE(3): the sphere2500 CLI run's ATE against its golden, the basin bound
# of tests/test_golden.py's blanket gate over the outlier goldens.
SE3_ATE_GATE_M = 1.0
# The sphere2500 recipe's gates: against its float64 references, twice the
# largest |relative difference| of float32 over the three factorisations,
# the initial poses and the perturbed copies, on the card and on the CPU
# (python -m slam_tpu_torch.tools.f32_spread --problem sphere2500
# --perturb 16, and --device cpu --perturb 4); PERF.md gives both.  f32
# lands up to half the cost away from f64 on this recipe (f64 under the
# same input noise moves by 6.6e-4), so this gate only catches a lost
# solve, and each factorisation must also bring the cost to
# SCALE_COST_FRAC x initial.
SE3_REF_COST_RTOL = 1.02       # 4.96e-1 / 5.09e-1
# The golden cells of tests/test_golden.py:46-76 on the dense solver:
# (dataset, outliers, seed, robust, ATE bound m, cost bound factor and
# offset on the golden's recorded final cost).
GOLDEN_CELLS = {
    "CSAIL_0out_seed0": ("CSAIL", 0, 0, "none", 0.05, 2.0, 0.05),
    "CSAIL_50out_seed42": ("CSAIL", 50, 42, "dcs", 0.10, 1.5, 0.0),
    "INTEL_0out_seed0": ("INTEL", 0, 0, "none", 0.05, 2.0, 0.05),
}
# Methods 3 and 4 (phase 9).  The default Nielsen eval of method 3 departs
# from the oracle's Ceres bookkeeping on INTEL+50; the JAX f32 engine's
# own record is an identical prefix of 127 (ROADMAP C-ref 4).
M3_NIELSEN_PREFIX = 127
# Gates on the largest differences from the oracle before the first
# divergence (method 3's Delta and edge residual, method 4's split value
# and Mahalanobis residual): twice the largest measured in float32 on the
# card and on the CPU (python -m slam_tpu_torch.tools.manager_spread, and
# --device cpu --dtype float32); PERF.md gives both.  In the comment, the
# largest card / CPU.  The Nielsen Delta is the eval's own departure from
# the oracle's Ceres bookkeeping: float64 on the card gives 2.38e-2 too.
MANAGER_DIFF_GATES = {
    "intel50_m4": {"split_value": 1.41e-4,   # 7.04e-5 / 5.74e-5
                   "residual": 0.200},       # 9.97e-2 / 7.86e-2
    "intel50_m3_ceres": {"delta": 3.76e-4,   # 1.88e-4 / 1.70e-4
                         "residual": 4.59e-3},  # 2.00e-3 / 2.29e-3
    "intel50_m3": {"delta": 4.76e-2,         # 2.38e-2 / 2.38e-2
                   "residual": 3.01e-3},     # 1.50e-3 / 1.15e-3
    "csail50_m3": {"delta": 3.17e-5,         # 1.38e-5 / 1.58e-5
                   "residual": 1.56e-3},     # 7.79e-4 / 4.41e-4
    "csail50_m4": {"split_value": 6.42e-5,   # 2.59e-5 / 3.21e-5
                   "residual": 0.182},       # 6.00e-2 / 9.10e-2
}
MANAGER_PHASES = {  # phase: its cells (slam_tpu_torch/tools/manager_spread)
    "method4_path": ("intel50_m4",),
    "method3_ceres": ("intel50_m3_ceres",),
    "method3_path": ("intel50_m3",),
    "csail_managers": ("csail50_m3", "csail50_m4"),
}
# The fused engines (phase 10a) on the Schur eval: the same gates, twice
# the largest float32 difference from the oracle on the card and on the
# CPU (python -m slam_tpu_torch.tools.manager_spread --fused on, and
# --device cpu --dtype float32 --fused on --eval-linear schur); PERF.md
# gives both.  In the comment, the largest card / CPU.
FUSED_MANAGER_DIFF_GATES = {
    "intel50_m4": {"split_value": 3.71e-5,   # 1.85e-5 / 1.38e-5
                   "residual": 3.81e-2},     # 1.08e-2 / 1.90e-2
    "intel50_m3_ceres": {"delta": 2.46e-4,   # 9.55e-5 / 1.23e-4
                         "residual": 2.90e-3},  # 1.45e-3 / 1.18e-3
    "intel50_m3": {"delta": 4.77e-2,         # 2.38e-2 / 2.38e-2
                   "residual": 2.90e-3},     # 1.45e-3 / 7.60e-4
    "csail50_m3": {"delta": 1.53e-5,         # 7.63e-6 / 6.26e-6
                   "residual": 1.11e-3},     # 5.53e-4 / 3.12e-4
    "csail50_m4": {"split_value": 2.02e-5,   # 1.01e-5 / 2.14e-6
                   "residual": 7.72e-2},     # 3.86e-2 / 1.70e-2
}
FUSED_CELLS = tuple(FUSED_MANAGER_DIFF_GATES)
# The PCG eval's host reads are counted on a run cut to this many closures.
FUSED_PCG_CANDIDATES = 8
# Phase 10b: fused against host in float64 (the JAX package's own test).
FUSED_VS_HOST_ATOL = 1e-9
# [manager_fold]: (a) each lane of a folded batch of short solves against
# its solve alone in float64 (the seed and chain batches' kind of
# difference: one batched factorisation against another); (b) the fused
# engines, folded and looped, on runs cut to FOLD_CANDIDATES closures.
FOLD_F64_RTOL = 1e-12
FOLD_F64_POSE_ATOL = 1e-10
FOLD_CANDIDATES = 32
# ... and their device time on runs cut to this many (a profiler session
# over the looped engine's ~5700 launches a candidate is slow).
FOLD_PROFILE_CANDIDATES = 8
# The managers' short-solve inputs of phase 2 come from a run cut to this
# many closures (cells: dataset, outliers, seed of the phase-9 runs; the
# fused engine's at INTEL+50 and M3500+50).
MANAGER_KERNEL_CANDIDATES = 32
MANAGER_KERNEL_CELLS = {"INTEL+50": ("INTEL", 50, 42),
                        "CSAIL+50": ("CSAIL", 50, 0)}
FUSED_KERNEL_CELLS = {"INTEL+50": ("INTEL", 50, 42),
                      "M3500+50": ("M3500", 50, 0)}
# Phase 11 (Woodbury, sweeps, distributed solvers, profiling).  The
# Woodbury plain-DCS run in float64 against its float64 JAX reference; the
# float32 run is gated on finite output only (the JAX package measured
# that its correction z - W y cancels in float32).
WOODBURY_REF_COST_RTOL = 1e-6
# [dist_edge]: ranks sharing the card, LM iterations, and the JAX test's
# tolerances against the single-process PCG (tests/test_distributed.py).
DIST_EDGE_RANKS = 4
DIST_EDGE_ITERS = 5
DIST_EDGE_TOL = {"cost0": 1e-10, "cost": 1e-6, "poses": 1e-5}
# [dist_schur]: tools/dist_check at P = 8 ranks; the replica batch of two
# CSAIL+50 seeds on 2 x 2 ranks against each seed alone on 2 ranks.
DIST_SCHUR_RANKS = 8
DIST_SCHUR_ITERS = 5
BATCH_SEEDS = (0, 1)
BATCH_ITERS = 6
BATCH_REL = 1e-6
# [dist_schur] in float64: CSAIL+50 on 2 ranks (each seed, the batch's
# replica rows and the batch) and on 4 ranks (contiguous and spectral)
# against the single-process Schur lm_fixed_iters at the same block count.
DIST_SCHUR_F64_TOL = {"cost0": 1e-12, "cost": 1e-9, "poses": 1e-7}
# [profile]: each kernel's symbol in a trace.
PROFILE_SYMBOLS = {"gather_rows": "gather_rows_kernel",
                   "scatter_add_rows": "scatter_add_rows_kernel",
                   "fused_linearize_se2": "linearize_se2_kernel",
                   "micro_chol_inv": "micro_chol_inv_kernel",
                   "stack_cholesky": "stack_chol::"}
# [stack_chol]: label -> (lanes, order) of the stacks the dense solver and
# the seed batch's Schur separators factor: the dense cell's joint SC
# systems (INTEL+50), and the separators of M3500+50, of the seed batch at
# M3500 and of the managers' evals at INTEL.
STACK_CHOL_SHAPES = {"dense_intel50_sc": (8, 5217),
                     "separator_m3500_50": (8, 3950),
                     "separator_m3500": (8, 1662),
                     "separator_intel": (8, 723)}
PANEL = 128               # schur_panel of the blocked path
# Panels of 128 that micro_chol_inv_folded takes on the blocked path: the
# rescue's chain batch (6 chains x 16 interiors) and the seed batch (8
# seeds x 16): the folded count's leading axis.
FOLDED_LEADS = {96: 6, 128: 8}
# [seed_batch]: its gate of bench.py (bench.py:161): every seed's cost0 >
# 2 and cost < 0.6 x cost0, after tools/problems.BATCH_ITERS (bench.py's
# LM_ITERS) iterations.
SEED_BATCH_COST0_MIN = 2.0
SEED_BATCH_COST_FRAC = 0.6
# Batched iterations under torch.profiler for the device time.
SEED_BATCH_PROFILE_ITERS = 10
# Each seed of the batch against its run alone, measured on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md).  In float64 (native and
# blocked-plain; the kernel takes float32 panels only), all the
# iterations: up to 2.7e-12 in cost and 2.5e-10 m in poses.  In float32,
# the first iteration of all three factorisations: up to 2.5e-6 in cost
# and 4.5e-5 m in poses; the gates are about 4x that.
SEED_BATCH_F64_RTOL = 1e-9
SEED_BATCH_F64_POSE_ATOL = 1e-8
SEED_BATCH_STEP_RTOL = 1e-5
SEED_BATCH_STEP_POSE_ATOL = 2e-4
# Each seed's float32 cost after all the iterations against its float64
# batch cost (native), per factorisation: twice the largest |relative
# difference| on the card over the float32 batch from the initial poses
# and 16 copies perturbed by 1e-7 (python -m
# slam_tpu_torch.tools.f32_spread --problem seed_batch --perturb 16; each
# seed alone lands inside).  One seed's trajectory leaves for another
# basin under a one-ulp move, so the spread is large.  The CPU's (--device
# cpu) is smaller for native and blocked-plain; its blocked-kernel runs
# the plain panel factor, another program (0.489).  The largest, card /
# CPU, in the comment.
SEED_BATCH_F32_RTOL = {
    "native": 0.517,         # 0.2583 / 0.2158
    "blocked_plain": 0.532,  # 0.2658 / 0.2078
    "blocked_micro": 0.44,   # 0.2197 / (0.4889, plain panel factor)
}
# [rescue_batch] (a): each lane of the batched float64 solve against its
# chain alone (the seed batch's float64 gates, from the same kind of
# difference: one batched factorisation against another).
RESCUE_F64_RTOL = 1e-9
RESCUE_F64_POSE_ATOL = 1e-8
# [pcg_batch] and [woodbury_batch] (a): the rescue's first round on PCG and
# Woodbury at those gates.  PCG's rounds are capped at PCG_ROUND_ITERS LM
# iterations: a chain's float64 LM iteration runs ~145 CG iterations at
# ~4 ms each (host-bound, PERF.md section 5), and the chains alone run in
# turns with the batch.  Launches of a batched LM iteration against one
# chain's: PCG with every CG run to PCG_FIXED_CG iterations (rtol 0).
PCG_ROUND_ITERS = 5
PCG_FIXED_CG = 16
# (b): LM it/s of the float32 seed batch against LANE_ALONE_SEEDS seeds
# alone, in turns, over LANE_TIMED_ITERS iterations (the gate's run takes
# BATCH_ITERS).
LANE_TIMED_ITERS = 5
LANE_ALONE_SEEDS = 2
# (c): the fused runs whose last batches the PCG eval's lanes are held to
# alone, cut to this many closures; the host engine above 2048 nodes
# (M3500+50 method 4, PCG eval) cut to HOST_PCG_CANDIDATES.
PCG_FOLD_CANDIDATES = 8
HOST_PCG_CANDIDATES = 4
# (b)'s device time of the PCG batch: one LM iteration of this many CG
# iterations under the profiler.
PCG_PROFILE_CG = 16
# The fused PCG eval's host reads per candidate while every evaluation was
# its own call ([fused_pcg] on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md);
# the fold must read less.
FUSED_PCG_LOOPED_READS = 28.25
# [sc_batch]: joint switchable constraints (method 2) in the seed batch,
# INTEL+50 x seeds 0-7 (tools/problems.intel50_seed_batch(..., "sc")), on
# each configuration of tools/problems.SC_BATCH_CONFIGS.  In float64 each
# seed of the batch against its run alone at the seed batch's float64
# gates (poses and switches), over SC_BATCH_F64_ITERS iterations (PCG
# capped: a seed's float64 LM iteration runs ~115 CG iterations at ~4 ms,
# host-bound); in float32 after one iteration at its first-iteration
# gates, but for SC_BATCH_STEP_TOL.  The float64 batch at the float32
# run's iterations is the float32 gate's reference (the blocked-kernel
# run's is native's; PCG's is SC_BATCH_PCG_F64).
SC_BATCH_F64_ITERS = {"native": 50, "blocked_micro": 50, "dense": 50,
                      "woodbury": 50, "pcg": 2}
# The blocked-kernel batch's first float32 iteration against each seed
# alone, (cost rel, poses m): measured on an NVIDIA H100 80GB HBM3 at
# 700 W up to 7.6e-6 and 3.5e-4 m (the blocked factor's batched matmuls
# pick another cuBLAS kernel at 8 x 16 interiors than at 16, and the
# eliminated system's interiors carry it further than DCS's 4.5e-5 m);
# the gates are about 4x that.  Its float64 run holds the lanes to their
# seeds at the float64 gates.
SC_BATCH_STEP_TOL = {"blocked_micro": (3e-5, 1.4e-3)}
# Phase 2 takes the joint-SC batch's real panels after this many batched
# iterations (native Schur, its dtype).
SC_PANEL_ITERS = 5
# Each seed's float32 cost after tools/problems.BATCH_ITERS iterations
# (PCG: SC_PCG_ITERS) against its float64 batch cost, per configuration:
# twice the largest |relative difference| on the card over the float32
# batch from the initial poses and 16 copies perturbed by 1e-7 (python -m
# slam_tpu_torch.tools.f32_spread --robust sc --problem seed_batch
# --perturb 16, NVIDIA H100 80GB HBM3, 700 W; each seed alone lands
# inside); the largest in the comment.
SC_BATCH_F32_RTOL = {
    "native": 0.048,         # 0.02363
    "blocked_micro": 0.032,  # 0.01593
    "dense": 0.039,          # 0.01919
    "woodbury": 0.080,       # 0.03999
    "pcg": 0.016,            # 0.00777
}
# The float64 PCG batch's costs after SC_PCG_ITERS iterations, the float32
# PCG gate's reference: the same f32_spread run's (its float64_pcg; the
# phase's own float64 batch gave the same digits), taken as constants
# since the run takes ~8 s of host-bound CG iterations.
SC_BATCH_PCG_F64 = [4.209143379901397, 3.414422106338442,
                    3.6736337778426167, 5.413528912856409,
                    3.457790469237093, 4.716206563900505,
                    4.029175713024489, 4.407989074659244]
# LM it/s of the float32 batch against the eight seeds alone, in turns,
# over SC_BATCH_TIMED_ITERS iterations; PCG against LANE_ALONE_SEEDS
# seeds over SC_PCG_TIMED_ITERS.
SC_BATCH_TIMED_ITERS = 10
SC_PCG_TIMED_ITERS = 2
KERNEL_INFO = {  # name: (source, TPU kernel it replaces, phase that runs it)
    "gather_rows": ("slam_tpu_torch/csrc/gather.cu",
                    "slam_tpu/ops/pallas_gather.py:56", "main_path"),
    "scatter_add_rows": ("slam_tpu_torch/csrc/gather.cu",
                         "slam_tpu/ops/pallas_gather.py:95", "main_path"),
    "fused_linearize_se2": ("slam_tpu_torch/csrc/linearize_se2.cu",
                            "slam_tpu/ops/pallas_linearize.py:203",
                            "main_path"),
    "micro_chol_inv": ("slam_tpu_torch/csrc/chol.cu",
                       "slam_tpu/ops/pallas_chol.py:92", "blocked_path"),
    "micro_chol_inv_folded": ("slam_tpu_torch/csrc/chol.cu",
                              "slam_tpu/ops/pallas_chol.py:119",
                              "seed_batch_blocked_micro"),
    "stack_cholesky": ("slam_tpu_torch/csrc/stack_chol.cu",
                       "none (the JAX package leaves the dense factor to "
                       "cho_factor)", "method2_dense"),
}
# The fold is a reshape in front of micro_chol_inv, whose wrapper counts
# the launch: a kernel's count, where it is not its name's.
KERNEL_COUNTER = {"micro_chol_inv_folded": "micro_chol_inv"}
PHASE_KERNELS = {
    "main_path": ("gather_rows", "scatter_add_rows", "fused_linearize_se2"),
    "blocked_path": ("gather_rows", "scatter_add_rows",
                     "fused_linearize_se2", "micro_chol_inv"),
    "method2_path": ("gather_rows", "scatter_add_rows"),
    "method2_varpro": ("gather_rows", "scatter_add_rows"),
    "method2_dense": ("gather_rows", "scatter_add_rows", "stack_cholesky"),
    "method2_ab": ("gather_rows", "scatter_add_rows", "micro_chol_inv"),
    "pcg_dcs": ("gather_rows", "scatter_add_rows", "fused_linearize_se2"),
    "pcg_sc": ("gather_rows", "scatter_add_rows"),
    "report_stages": ("gather_rows", "scatter_add_rows"),
    "se3_path": ("gather_rows", "scatter_add_rows"),
    "se3_ab": ("gather_rows", "scatter_add_rows", "micro_chol_inv"),
    "golden": ("gather_rows", "scatter_add_rows", "fused_linearize_se2"),
    "seed_batch_native": ("gather_rows", "scatter_add_rows",
                          "fused_linearize_se2"),
    "seed_batch_blocked_plain": ("gather_rows", "scatter_add_rows",
                                 "fused_linearize_se2"),
    "seed_batch_blocked_micro": ("gather_rows", "scatter_add_rows",
                                 "fused_linearize_se2", "micro_chol_inv"),
    "rescue_batch": ("gather_rows", "scatter_add_rows",
                     "fused_linearize_se2"),
    # Joint SC takes the plain linearisation, as alone: no
    # fused_linearize_se2 (sc_batch checks that it is not launched).
    **{f"sc_batch_{name}": ("gather_rows", "scatter_add_rows")
       for name in ("native", "dense", "woodbury", "pcg")},
    "sc_batch_blocked_micro": ("gather_rows", "scatter_add_rows",
                               "micro_chol_inv"),
    "rescue_batch_dense": ("gather_rows", "scatter_add_rows",
                           "fused_linearize_se2"),
    **{phase: ("gather_rows", "scatter_add_rows", "fused_linearize_se2")
       for phase in ("pcg_batch", "pcg_batch_seeds", "pcg_eval_host",
                     "woodbury_batch", "woodbury_batch_seeds")},
    **{phase: ("gather_rows", "scatter_add_rows", "fused_linearize_se2")
       for phase in (*MANAGER_PHASES, "fused_managers", "fused_vs_host",
                     "fused_m3500", "manager_fold", "woodbury_path", "sweep", "dist_edge",
                     "dist_edge_nccl", "dist_schur", "dist_schur_spectral",
                     "profile")},
}
#: What the main path and phase 11's [profile] compare.
MAIN_RUN = {}
#: The consensus rounds and the solve record of each run through the
#: rescue (phases 3 and 6a), for [rescue_batch] (b).
RESCUE_RUNS = {}
# Launches per LM iteration of native INTEL plain DCS (phase 6d): one
# gather per source outside the linearisation (which reads its endpoints
# itself) and one scatter per group of sums.
LAUNCH_LIMITS = {"gather_rows": 4, "scatter_add_rows": 4}
REPS = 50                 # calls per timing


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def in_turns(fns: dict, reps: dict) -> dict:
    """CUDA-event ms of each function, timed in the order a, b, .., b, a
    and averaged over both turns."""
    from slam_tpu_torch.tools.kernel_times import cuda_ms

    order = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cuda_ms(fns[k], reps[k]))
    return {k: sum(v) / len(v) for k, v in times.items()}


def max_err(a, b) -> tuple[float, float]:
    """(max abs error, max(1, max |b|)) of two tensors."""
    err = (a - b).abs().max().item() if a.numel() else 0.0
    scale = max(1.0, b.abs().max().item() if b.numel() else 0.0)
    return err, scale


def require_launches(phase: str, counts: dict) -> None:
    missing = [k for k in PHASE_KERNELS[phase] if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {phase}: "
                             f"{missing}")


def real_panels(edges, free, poses, part, robust: str = "dcs",
                switches=None) -> dict:
    """The first and the trailing diagonal panel that the blocked
    factorisation of the equilibrated interiors hands to the panel factor
    at ``poses`` and lambda = 1e-4; under joint SC (``robust="sc"``, at
    ``switches``) those of the system with the switches eliminated, as
    the Schur solver gets it."""
    from slam_tpu_torch.solver import blocked_chol as bc
    from slam_tpu_torch.solver.linear import eliminate_switches
    from slam_tpu_torch.solver.linearize import linearize
    from slam_tpu_torch.solver.models import model_for_dim
    from slam_tpu_torch.solver.schur import assemble

    sw = torch.ones((edges.num_edges,), dtype=poses.dtype,
                    device=poses.device) if switches is None else switches
    lam = torch.tensor(1e-4, dtype=poses.dtype, device=poses.device)
    system = linearize(poses, sw, edges, free,
                       model=model_for_dim(poses.shape[-1]), robust=robust,
                       dcs_phi=0.5, huber_delta=0.01, sc_prior_lambda=1.0)
    if robust == "sc":  # every problem at the same lambda
        system, _ = eliminate_switches(system, edges, lam)
    A = assemble(system, part, lam).A
    P, n, _ = A.shape
    fac = bc.blocked_cholesky(A, panel=PANEL)
    n_pad = fac.L.shape[-1]
    A_pad = torch.zeros((P, n_pad, n_pad), dtype=A.dtype, device=A.device)
    A_pad[:, :n, :n] = A
    A_pad[:, n:, n:] = torch.eye(n_pad - n, dtype=A.dtype, device=A.device)
    row = fac.L[:, -PANEL:, :-PANEL]
    trailing = A_pad[:, -PANEL:, -PANEL:] - row @ row.transpose(-1, -2)
    return {"first": A_pad[:, :PANEL, :PANEL].contiguous(),
            "trailing": trailing.contiguous(), "n": n, "n_pad": n_pad}


def residuals(A, L, inv) -> tuple[float, float]:
    """max|L L^T - A| and max|inv L - I|, evaluated in float64."""
    L64, inv64, A64 = L.double(), inv.double(), A.double()
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    r_fac = (L64 @ L64.transpose(-1, -2) - A64).abs().max().item()
    r_inv = (inv64 @ L64 - eye).abs().max().item()
    return r_fac, r_inv


def check_chol(label: str, A, dtype_name: str, gate: str,
               lead: tuple = ()) -> float:
    """Kernel vs plain on one batch ``A (M, p, p)``; ``gate`` is "spd"
    (elementwise tolerance) or "residual" (against the plain version's
    residuals).  With ``lead``, the kernel is ``micro_chol_inv_folded`` on
    the ``(*lead, M / prod(lead), p, p)`` view, held to the plain version
    of the flat batch.  Returns the max abs error of L and inv against the
    plain version."""
    from slam_tpu_torch.ops.chol import micro_chol_inv, \
        micro_chol_inv_folded, micro_chol_inv_plain

    name = "micro_chol_inv_folded" if lead else "micro_chol_inv"
    if lead:
        view = A.view(*lead, -1, *A.shape[1:])
        Lk, ik = micro_chol_inv_folded(view)
        if Lk.shape != view.shape or ik.shape != view.shape:
            raise AssertionError(f"{name} {label}: shapes {Lk.shape}, "
                                 f"{ik.shape} for {view.shape}")
        Lk, ik = Lk.reshape(A.shape), ik.reshape(A.shape)
    else:
        Lk, ik = micro_chol_inv(A)
    torch.cuda.synchronize()
    Lp, ip = micro_chol_inv_plain(A)
    p = A.shape[-1]
    if not torch.equal(Lk, Lp):
        raise AssertionError(f"{name} {label} {dtype_name}: L not "
                             "bitwise equal to the plain version's")
    upper = torch.triu(torch.ones(p, p, dtype=torch.bool, device=A.device),
                       1)
    if not (bool((Lk[:, upper] == 0).all()) and bool((ik[:, upper] == 0)
                                                      .all())):
        raise AssertionError(f"{name} {label} {dtype_name}: strict "
                             "upper triangle not exactly 0")
    (eL, sL), (ei, si) = max_err(Lk, Lp), max_err(ik, ip)
    rk, rp = residuals(A, Lk, ik), residuals(A, Lp, ip)
    log("kernels", kernel=name, shape=label, dtype=dtype_name,
        batch=json.dumps(list(A.shape)), err_L=eL, err_inv=ei,
        resid_fac_kernel=rk[0], resid_fac_plain=rp[0],
        resid_inv_kernel=rk[1], resid_inv_plain=rp[1])
    if gate == "spd":
        tol = TOL[A.dtype]
        if not (eL <= tol * sL and ei <= tol * si):
            raise AssertionError(
                f"{name} {label} {dtype_name}: err L {eL} (scale "
                f"{sL}), inv {ei} (scale {si}) above {tol} x scale")
    else:
        # A floor of a few units of roundoff keeps an exact-zero plain
        # residual from failing a kernel that is off by one rounding.
        eps = torch.finfo(A.dtype).eps
        floor = 4 * eps * max(1.0, A.abs().max().item())
        for what, k, pl in (("L L^T - A", rk[0], rp[0]),
                            ("inv L - I", rk[1], rp[1])):
            if not (np.isfinite(k) and k <= max(RESID_FACTOR * pl, floor)):
                raise AssertionError(
                    f"{name} {label} {dtype_name}: residual {what} "
                    f"{k} > {RESID_FACTOR} x plain {pl}")
    return max(eL, ei)


def check_launches(calls, label: str, name: str) -> float:
    """Every gather and scatter launch of a recorded LM iteration, again on
    its own inputs: a gather bitwise equal to ``index_select``; a scatter
    launch bitwise equal to itself run again and to each of its groups
    launched alone, and within TOL of its plain version.  Returns the
    largest scatter error."""
    from slam_tpu_torch.ops.gather import gather_rows, scatter_add_groups, \
        scatter_add_groups_plain, scatter_add_rows

    worst = 0.0
    for fname, args, _ in calls:
        if fname == "gather_rows":
            x, idx = args
            got = gather_rows(x, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, x.index_select(0, idx.long())):
                raise AssertionError(f"gather_rows {label} {name}: not "
                                     "bitwise equal to index_select")
        elif fname in ("scatter_add_rows", "scatter_add_groups"):
            groups = args[0] if fname == "scatter_add_groups" else (args,)
            first = scatter_add_groups(groups)
            again = scatter_add_groups(groups)
            alone = [scatter_add_rows(v, plan) for v, plan in groups]
            torch.cuda.synchronize()
            plain = scatter_add_groups_plain(groups)
            for k, (a, b, c, d) in enumerate(zip(first, again, alone, plain)):
                what = f"scatter_add_rows {label} {name} group {k}"
                if not torch.equal(a, b):
                    raise AssertionError(f"{what}: two runs differ")
                if not torch.equal(a, c):
                    raise AssertionError(f"{what}: differs from the group "
                                         "launched alone")
                err, scale = max_err(a, d)
                if not err <= TOL[a.dtype] * scale:
                    raise AssertionError(f"{what}: err {err} > {TOL[a.dtype]}"
                                         f" x {scale}")
                worst = max(worst, err)
    return worst


def linearize_errs(what: str, got: dict, plain: dict, dtype) -> dict:
    """(err, scale) of each linearisation output against its plain
    version; raises where one is above TOL x scale."""
    errs = {k: max_err(got[k], plain[k]) for k in plain}
    bad = {k: v for k, v in errs.items() if not v[0] <= TOL[dtype] * v[1]}
    if bad:
        raise AssertionError(f"fused_linearize_se2 {what}: (err, scale) "
                             f"above {TOL[dtype]} x scale: {bad}")
    return errs


def check_short_solves(label: str, cfg, plan, cases: dict, dtype) -> None:
    """Each case's LM iteration under ``cfg`` and ``plan`` (one problem's,
    or a batch's) recorded and replayed through :func:`check_launches`,
    its launches required, and the linearisation on its masks held to the
    plain version."""
    from slam_tpu_torch.ops.linearize import fused_linearize_se2_indexed, \
        fused_linearize_se2_indexed_plain
    from slam_tpu_torch.tools import kernel_times as kt

    name = str(dtype).replace("torch.", "")
    for kind, args in cases.items():
        what = f"{label}-{kind}"
        poses, _, edges, free = args
        calls, counts, _ = kt.record_iteration(args, cfg, plan)
        missing = [k for k in PHASE_KERNELS["main_path"]
                   if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{what} {name}: {missing} not launched")
        scatter_err = check_launches(calls, what, name)
        lin = (cfg.dcs_phi, cfg.huber_delta)
        got = fused_linearize_se2_indexed(
            poses, free.node, edges, *lin, robust=cfg.robust)
        torch.cuda.synchronize()
        errs = linearize_errs(
            f"{what} {name}", got, fused_linearize_se2_indexed_plain(
                poses, free.node, edges.ab, edges.meas, edges.loop_f,
                edges.active, *lin, cfg.robust), dtype)
        lanes = getattr(plan, "seeds", None) or 1
        solver = ({"dense_unknowns": 3 * poses.shape[0] // lanes}
                  if cfg.linear_solver == "dense" else
                  {"plan": cfg.linear_solver})
        log("kernels", shape=what, dtype=name, lanes=lanes, **solver,
            edges=edges.num_edges, nodes=poses.shape[0],
            active_edges=int(edges.active.sum().item()),
            free_nodes=int(free.node.sum().item()),
            checked_calls=len(calls), scatter_max_abs_err=scatter_err,
            linearize_max_abs_err=max(e for e, _ in errs.values()),
            launches_per_run=json.dumps(counts))


def check_manager_shapes(device, dtype, graphs: dict,
                         fused_graphs: dict) -> None:
    """Phase 2 on the short solves of methods 3 and 4 (see the module
    docstring): the host engines' inputs on the pose-only dense plan, and
    the fused method-3 engine's on its Schur plan."""
    from slam_tpu_torch.tools.manager_spread import fused_solve_inputs, \
        short_solve_inputs

    name = str(dtype).replace("torch.", "")
    for cell, graph in graphs.items():
        for method in (3, 4):
            ss, cases = short_solve_inputs(graph, method, device, name,
                                           MANAGER_KERNEL_CANDIDATES)
            check_short_solves(f"{cell}-m{method}", ss.cfg, ss.plan, cases,
                               dtype)
    for cell, graph in fused_graphs.items():
        ss, cases = fused_solve_inputs(graph, device, name,
                                       MANAGER_KERNEL_CANDIDATES)
        if ss.cfg.linear_solver != "schur" or set(cases) != {"candidate",
                                                             "window"}:
            raise AssertionError(f"{cell} fused: {ss.cfg.linear_solver} "
                                 f"plan, cases {sorted(cases)}")
        for kind, (args, plan) in cases.items():
            check_short_solves(f"{cell}-fused-m3", ss.cfg, plan,
                               {kind: args}, dtype)


def one_rank_mesh(axis: str, device):
    """A one-rank mesh of this process (its group must be joined) for
    replaying one rank's kernel calls at the distributed shapes."""
    from slam_tpu_torch.parallel.mesh import Mesh

    return Mesh(axes=(axis,), shape={axis: 1}, index={axis: 0},
                groups={axis: None}, rank=0, world_size=1, device=device)


def check_phase11_shapes(device, dtype) -> None:
    """Phase 2 on phase 11's shapes: one Woodbury iteration of INTEL+50
    (the low-rank rows' gather, the grouped scatter of U and the
    subtracted diagonals); one rank's calls of the edge-parallel LM (a
    quarter of INTEL+50's padded edges, as at DIST_EDGE_RANKS ranks: the
    linearisation, the matvec's gather and scatter, 3 CG iterations) and
    of the distributed Schur LM (block 3 of M3500+50 cut into
    DIST_SCHUR_RANKS contiguous blocks: the slot gather, the grouped
    assembly into the block grids, the update's scatter), each recorded
    and replayed through :func:`check_launches`, and the linearisation
    on the edge shard held to its plain version.  The distributed calls
    run in a one-rank gloo group of this process (their reductions are
    identities, so the numbers are not a solve's)."""
    import torch.distributed as dist

    from slam_tpu_torch.config import SolverConfig
    from slam_tpu_torch.io import g2o
    from slam_tpu_torch.ops.linearize import fused_linearize_se2_indexed, \
        fused_linearize_se2_indexed_plain
    from slam_tpu_torch.parallel import distributed, schur_dist
    from slam_tpu_torch.parallel.mesh import BLOCK_AXIS, EDGE_AXIS, Mesh
    from slam_tpu_torch.solver.models import SE2Model
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph
    from slam_tpu_torch.tools import kernel_times as kt
    from slam_tpu_torch.tools.problems import intel50_plain

    name = str(dtype).replace("torch.", "")
    prob = intel50_plain(device, name, "dcs", "woodbury")
    args = (prob.poses0, prob.switches0, prob.edges, prob.free)
    calls, counts, _ = kt.record_iteration(args, prob.scfg, prob.partition)
    log("kernels", shape="INTEL-woodbury", dtype=name,
        lowrank_edges=prob.partition.num_lowrank, checked_calls=len(calls),
        scatter_max_abs_err=check_launches(calls, "INTEL-woodbury", name),
        launches_per_run=json.dumps(counts))

    with tempfile.TemporaryDirectory() as rdv:
        dist.init_process_group("gloo", init_method=f"file://{rdv}/r",
                                rank=0, world_size=1)
        try:
            g = g2o.load_g2o(g2o.find_dataset("INTEL")).add_random_outliers(
                50, seed=42).canonical_order()
            edges = distributed.pad_edges_for_mesh(
                edge_set_from_graph(g, dtype=dtype, device=device),
                DIST_EDGE_RANKS)
            k = 1
            shard = distributed.shard_edges(edges, Mesh(
                axes=(EDGE_AXIS,), shape={EDGE_AXIS: DIST_EDGE_RANKS},
                index={EDGE_AXIS: k}, groups={EDGE_AXIS: None}, rank=k,
                world_size=DIST_EDGE_RANKS, device=device))
            poses = torch.as_tensor(g.poses, dtype=dtype, device=device)
            free = anchor_first_node(g.num_nodes, dtype=dtype, device=device)
            cfg = SolverConfig(robust="dcs", linear_solver="pcg",
                               dtype=name, pcg_max_iters=3)
            calls = kt.record(lambda: distributed.distributed_lm(
                poses, shard, free, cfg, one_rank_mesh(EDGE_AXIS, device),
                1))
            what = f"INTEL-edge-shard{k}of{DIST_EDGE_RANKS}"
            got = fused_linearize_se2_indexed(poses, free.node, shard, 0.5,
                                              0.01, robust="dcs")
            torch.cuda.synchronize()
            errs = linearize_errs(f"{what} {name}", got,
                                  fused_linearize_se2_indexed_plain(
                                      poses, free.node, shard.ab, shard.meas,
                                      shard.loop_f, shard.active, 0.5, 0.01,
                                      "dcs"), dtype)
            log("kernels", shape=what, dtype=name, edges=shard.num_edges,
                checked_calls=len(calls),
                scatter_max_abs_err=check_launches(calls, what, name),
                linearize_max_abs_err=max(e for e, _ in errs.values()))

            m = g2o.load_g2o(g2o.find_dataset("M3500")).add_random_outliers(
                50, seed=0).canonical_order()
            dprob = schur_dist.build_dist_problem(m, DIST_SCHUR_RANKS)
            k = 3
            block = schur_dist.shard_problem(dprob, k, m.num_nodes,
                                             dtype=dtype, device=device)
            mposes = torch.as_tensor(m.poses, dtype=dtype, device=device)
            mfree = anchor_first_node(m.num_nodes, dtype=dtype,
                                      device=device)
            calls = kt.record(lambda: schur_dist._schur_lm_shard(
                mposes, block, mfree, cfg.replace(linear_solver="schur"),
                one_rank_mesh(BLOCK_AXIS, device), 1, SE2Model))
            what = f"M3500-block{k}of{DIST_SCHUR_RANKS}"
            log("kernels", shape=what, dtype=name, ni=dprob.ni, ns=dprob.ns,
                ek=dprob.ek, checked_calls=len(calls),
                scatter_max_abs_err=check_launches(calls, what, name))
        finally:
            dist.destroy_process_group()


def summary_row(rows: list, prefix: str) -> dict:
    """The timing row of the call labelled ``prefix``."""
    for row in rows:
        if row["call"].startswith(prefix):
            return row
    raise AssertionError(f"no timed call {prefix!r}")


def time_launches(label: str, calls, names, peaks, plain, summary):
    """The float32 timings of a recorded iteration's kernel calls; with
    ``plain`` (INTEL), the result line's numbers of the gather, the scatter
    and the linearisation.  Returns ``(rows, fns, report)`` for
    :func:`phase_kernel_times`."""
    from slam_tpu_torch.tools import kernel_times as kt

    rows, fns = kt.measure_calls(calls, names, peaks, REPS)
    plain = plain or {}
    plain_ms = {k: kt.cuda_ms(fp, REPS) for k, (_, fp, _, _) in plain.items()}

    def report():
        for row in rows:
            print("[kernels] " + json.dumps(
                {"shape": label, "dtype": "float32", **row}), flush=True)
        for kname, (err, _, prefix, b) in plain.items():
            row = summary_row(rows, prefix)
            b_ms, b_by = b or (row["bound_ms"], row["bound_by"])
            summary[kname] = dict(
                max_abs_err=err, ms=row["ms"], device_ms=row["device_ms"],
                host_us=row["host_us"], plain_ms=plain_ms[kname],
                bound_ms=b_ms, bound_by=b_by, library_ms=row["library_ms"])

    return rows, fns, report


def time_chol(A, err: float, peaks, summary, lead: tuple = ()):
    """Times of ``micro_chol_inv`` on one SPD batch against its plain
    version and the library pair; with ``lead``, of
    ``micro_chol_inv_folded`` on the ``(*lead, M / prod(lead), p, p)``
    view; with ``summary``, the result line's.  Returns ``(rows, fns,
    report)`` for :func:`phase_kernel_times`."""
    from slam_tpu_torch.ops.chol import micro_chol_inv, \
        micro_chol_inv_folded, micro_chol_inv_plain, schedule, sm_count
    from slam_tpu_torch.tools import kernel_times as kt

    m = A.shape[0]
    shape = schedule(m, A.shape[-1], A.dtype, sm_count(A.get_device()))
    name = "micro_chol_inv_folded" if lead else "micro_chol_inv"
    if lead:
        A4 = A.view(*lead, -1, *A.shape[1:])

        def kernel():
            return micro_chol_inv_folded(A4)
    else:
        def kernel():
            return micro_chol_inv(A)
    nbytes, ops, library = kt.chol_work(A)
    t = in_turns({"kernel": kernel,
                  "plain": lambda: micro_chol_inv_plain(A),
                  "library": library},
                 {"kernel": REPS, "plain": 3, "library": REPS})
    b_ms, b_by = kt.bound(peaks, A.dtype, nbytes, ops)
    row = dict(max_abs_err=err, ms=t["kernel"],
               host_us=kt.host_us(kernel, REPS),
               plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by,
               library_ms=t["library"])

    def report():
        log("kernels", kernel=name, shape=f"spd{m}",
            dtype=str(A.dtype).replace("torch.", ""), max_abs_err=err,
            ms=round(row["ms"], 5),
            device_ms=round(row["device_ms"], 5),
            device_kernels_per_call=row["device_events"],
            launches_per_call=1, schedule=json.dumps(shape._asdict()),
            host_us=round(row["host_us"], 2),
            plain_ms=round(row["plain_ms"], 5),
            library_ms=round(row["library_ms"], 5), bound_ms=round(b_ms, 6),
            bound_by=b_by, schedule_kernels_per_call=shape.kernels,
            device_ms_by_kernel=json.dumps({
                k.split("(")[0]: round(ms, 5)
                for k, ms in row["device_kernels"].items()}))
        if summary is not None:
            summary[name] = {
                k: v for k, v in row.items()
                if k not in ("device_events", "device_kernels")}

    return [row], [kernel], report


def phase_kernel_times(timings: list) -> None:
    """Phase 9: the host-sensitive times of every job first, then all the
    device times under torch.profiler (a profiler session leaves the
    later host-bound calls of its process slower), then the lines."""
    from slam_tpu_torch.tools import kernel_times as kt

    done = [job() for job in timings]
    for rows, fns, _ in done:
        kt.add_device_times(rows, fns, REPS)
    for _, _, report in done:
        report()


def phase_kernels(device, peaks, timings: list) -> dict:
    """Kernel vs plain at the main path's shapes.  The kernels' timings are
    appended to ``timings`` to run after the end-to-end phases, so no
    profiler session runs before the LM rates that other trees are
    compared on.  Returns the dict those timings fill with the float32
    numbers per kernel for the result line (INTEL shapes; the SPD batch
    of 16 panels for ``micro_chol_inv``)."""
    from slam_tpu_torch.ops.gather import gather_rows, gather_rows_plain, \
        scatter_add_rows_plain
    from slam_tpu_torch.ops.linearize import fused_linearize_se2, \
        fused_linearize_se2_indexed, fused_linearize_se2_indexed_plain, \
        fused_linearize_se2_plain
    from slam_tpu_torch.solver import linear
    from slam_tpu_torch.tools import kernel_times as kt
    from slam_tpu_torch.tools.manager_streams import cell_graph
    from slam_tpu_torch.tools.problems import CONFIGS, intel50, \
        intel50_plain, m10000, sphere2500

    summary = {}
    manager_graphs = {cell: cell_graph(*c).canonical_order()
                      for cell, c in MANAGER_KERNEL_CELLS.items()}
    fused_graphs = {cell: cell_graph(*c).canonical_order()
                    for cell, c in FUSED_KERNEL_CELLS.items()}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        prob = intel50(device, name)
        m = m10000(device, dtype)
        shapes = {"INTEL": ((prob.poses0, prob.switches0, prob.edges,
                             prob.free), prob.scfg, prob.partition),
                  "M10000": (m.args, m.cfg, m.partition)}
        for label, (args, cfg, part) in shapes.items():
            poses, _, edges, free = args
            E, N = edges.num_edges, poses.shape[0]
            # In float32 the recorded calls end with the first
            # micro_chol_inv call of a blocked iteration: the real batch.
            calls, counts, names = kt.record_iteration(
                args, cfg, part, cfg.replace(**CONFIGS["blocked_micro"])
                if dtype == torch.float32 else None)
            both = gather_rows(poses, edges.ab)
            alone = (gather_rows(poses, edges.plan_a.idx),
                     gather_rows(poses, edges.plan_b.idx))
            torch.cuda.synchronize()
            if not (torch.equal(both[:E], alone[0])
                    and torch.equal(both[E:], alone[1])):
                raise AssertionError(f"gather_rows {label} {name}: [a; b] "
                                     "differs from a and b gathered alone")
            scatter_err = check_launches(calls, label, name)
            log("kernels", shape=label, dtype=name, edges=E, nodes=N,
                checked_calls=len(calls), scatter_max_abs_err=scatter_err,
                launches_per_run=json.dumps(counts))

            pa, pb = gather_rows_plain(poses, edges.ab).split(E)
            fa, fb = gather_rows_plain(free.node, edges.ab).split(E)
            lin_args = (pa, pb, edges.meas, fa, fb, edges.loop_f,
                        edges.active, 0.5, 0.01)
            ix_args = (poses, free.node, edges.ab, edges.meas, edges.loop_f,
                       edges.active, 0.5, 0.01)
            for robust in ("dcs", "none"):
                l_i = fused_linearize_se2_indexed(poses, free.node, edges,
                                                  0.5, 0.01, robust=robust)
                l_k = fused_linearize_se2(*lin_args, robust=robust)
                torch.cuda.synchronize()
                if not all(torch.equal(l_i[k], l_k[k]) for k in l_k):
                    raise AssertionError(
                        f"fused_linearize_se2 {label} {name} {robust}: the "
                        "indexed entry differs from the gathered one")
                for what, got, plain in (
                        ("indexed", l_i, fused_linearize_se2_indexed_plain(
                            *ix_args, robust=robust)),
                        ("gathered", l_k, fused_linearize_se2_plain(
                            *lin_args, robust=robust))):
                    errs = linearize_errs(f"{what} {label} {name} {robust}",
                                          got, plain, dtype)
                    if robust == "dcs" and what == "indexed":
                        lin_err = max(e for e, _ in errs.values())
                        Haa = plain["Haa"]

            if dtype == torch.float32:
                plain = None
                if label == "INTEL":
                    plain = {
                        "gather_rows": (
                            0.0, lambda x=poses, i=edges.ab:
                            gather_rows_plain(x, i),
                            "gather_rows edges.ab x[", None),
                        "scatter_add_rows": (
                            scatter_err, lambda v=Haa, p=edges.plan_a:
                            scatter_add_rows_plain(v, p),
                            "scatter_add_rows edges.plan_a v[", None),
                        "fused_linearize_se2": (
                            lin_err, lambda a=ix_args:
                            fused_linearize_se2_indexed_plain(
                                *a, robust="dcs"),
                            "fused_linearize_se2_indexed ", None),
                    }
                timings.append(functools.partial(
                    time_launches, label, calls, names, peaks, plain,
                    summary))

            panels = real_panels(edges, free, poses, part)
            log("kernels", panels=label, dtype=name, blocks=part.num_blocks,
                interior_dim=panels["n"], padded=panels["n_pad"])
            for which in ("first", "trailing"):
                check_chol(f"{label}-{which}", panels[which], name,
                           "residual")

        # Method 2 on INTEL: one iteration of joint SC with the switches
        # eliminated before the Schur solver, on the dense joint system,
        # and on PCG (capped at 3 CG iterations).
        m2 = intel50_plain(device, name, "sc", "schur")
        m2_args = (m2.poses0, m2.switches0, m2.edges, m2.free)
        for solver, plan in (("schur", m2.partition),
                             ("dense", linear.dense_plan(m2.edges,
                                                         switches=True)),
                             ("pcg", None)):
            cfg = m2.scfg.replace(linear_solver=solver, pcg_max_iters=3)
            calls, counts, _ = kt.record_iteration(m2_args, cfg, plan)
            label = f"INTEL-sc-{solver}"
            log("kernels", shape=label, dtype=name,
                checked_calls=len(calls),
                scatter_max_abs_err=check_launches(calls, label, name),
                launches_per_run=json.dumps(counts))

        chains = check_chain_batches(device, dtype)
        check_sc_batch(device, dtype)
        check_manager_shapes(device, dtype, manager_graphs, fused_graphs)
        check_phase11_shapes(device, dtype)

        # SE(3), D = 6: one iteration of the sphere2500 recipe under the
        # native and the blocked factorisation (in float32 the blocked
        # iteration's panels go through micro_chol_inv), and the real
        # panels of its interiors.
        sph = sphere2500(device, dtype)
        for cname in ("native", "blocked_micro"):
            cfg = sph.cfg.replace(**CONFIGS[cname])
            calls, counts, names = kt.record_iteration(sph.args, cfg,
                                                       sph.partition)
            label = f"sphere2500-{cname}"
            log("kernels", shape=label, dtype=name,
                edges=sph.args[2].num_edges, nodes=sph.graph.num_nodes,
                checked_calls=len(calls),
                scatter_max_abs_err=check_launches(calls, label, name),
                launches_per_run=json.dumps(counts))
            if dtype == torch.float32:
                timings.append(functools.partial(
                    time_launches, label, calls, names, peaks, None,
                    summary))
        poses, _, edges, free = sph.args
        panels = real_panels(edges, free, poses, sph.partition)
        log("kernels", panels="sphere2500", dtype=name,
            blocks=sph.partition.num_blocks, interior_dim=panels["n"],
            padded=panels["n_pad"])
        for which in ("first", "trailing"):
            check_chol(f"sphere2500-{which}", panels[which], name,
                       "residual")

        # SPD batches at the path's panel counts (16 INTEL, 32 M10000),
        # timed; and at larger batches, past 4 m > the SM count, where the
        # kernel splits the factor and the inverse; 96 and 128 are the
        # folded shapes of the chain batch (6 chains x 16 interiors) and
        # the seed batch (8 seeds x 16), timed through the fold.
        for m in (16, 32, 48, 80, 96, 128):
            rng = np.random.default_rng(m)
            G = rng.normal(size=(m, PANEL, PANEL))
            A = torch.as_tensor(G @ G.transpose(0, 2, 1)
                                + PANEL * np.eye(PANEL),
                                dtype=dtype, device=device)
            err = check_chol(f"spd{m}", A, name, "spd")
            if m <= 32:
                timings.append(functools.partial(
                    time_chol, A, err, peaks,
                    summary if m == 16 and dtype == torch.float32
                    else None))
            elif m in FOLDED_LEADS:
                lead = (FOLDED_LEADS[m],)
                err = max(err, check_folded(device, A, lead, chains
                                            if m == 128 else None))
                timings.append(functools.partial(
                    time_chol, A, err, peaks,
                    summary if m == 128 and dtype == torch.float32
                    else None, lead=lead))
    return summary


def time_stack_chol(A, d, label: str, resid: float, peaks, summary):
    """Times of ``stack_cholesky`` on one scaled stack against the plain
    route (``cholesky_ex`` a lane, with the scaling products) and the
    cuSOLVER loop on the scaled stack (what the dense solver ran before
    the kernel); with ``summary``, the result line's.  Returns ``(rows,
    fns, report)`` for :func:`phase_kernel_times`."""
    from slam_tpu_torch.ops.stack_chol import schedule, stack_cholesky, \
        stack_cholesky_plain
    from slam_tpu_torch.tools import kernel_times as kt

    B, n, _ = A.shape
    Hs = A * d[:, :, None] * d[:, None, :]

    def kernel():
        return stack_cholesky(A, d)

    t = in_turns({"kernel": kernel,
                  "plain": lambda: stack_cholesky_plain(A, d),
                  "library": lambda: stack_cholesky_plain(Hs)},
                 {"kernel": 10, "plain": 5, "library": 5})
    b_ms, b_by = kt.bound(peaks, A.dtype, *kt.cholesky_work(
        n, B, A.element_size()))
    shape = schedule(n, A.dtype)
    row = dict(max_resid=resid, ms=t["kernel"],
               host_us=kt.host_us(kernel, 10), plain_ms=t["plain"],
               bound_ms=b_ms, bound_by=b_by, library_ms=t["library"])

    def report():
        log("kernels", kernel="stack_cholesky", shape=label,
            batch=json.dumps([B, n, n]),
            dtype=str(A.dtype).replace("torch.", ""),
            schedule=json.dumps(shape._asdict()),
            launches_per_call=shape.launches(n), max_resid=resid,
            ms=round(row["ms"], 5), device_ms=round(row["device_ms"], 5),
            device_kernels_per_call=row["device_events"],
            host_us=round(row["host_us"], 2),
            plain_ms=round(row["plain_ms"], 5),
            library_ms=round(row["library_ms"], 5), bound_ms=round(b_ms, 6),
            bound_by=b_by, roofline_pct=round(100 * b_ms / row["ms"], 3),
            device_ms_by_kernel=json.dumps({
                k.split("(")[0]: round(ms, 5)
                for k, ms in row["device_kernels"].items()}))
        if summary is not None:
            summary["stack_cholesky"] = {
                k: v for k, v in row.items()
                if k not in ("device_events", "device_kernels")}

    return [row], [kernel], report


def phase_stack_chol(device, peaks, timings: list) -> dict:
    """The stack factor (``csrc/stack_chol.cu``) at the dense solver's and
    the Schur separators' stacks (:data:`STACK_CHOL_SHAPES`), float32 and
    float64: every lane factored (info 0), the launch count, zeros above
    the diagonal, the residual max|L L^T - (A_ij d_i) d_j| in float64
    within RESID_FACTOR of the cuSOLVER loop's (or a few units of
    roundoff), and the first and last lanes equal to their matrices
    factored alone, to the bit.  The float32 timings go to ``timings``;
    returns the dict they fill with the dense stack's numbers for the
    result line."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.ops.stack_chol import schedule, stack_cholesky, \
        stack_cholesky_plain
    from slam_tpu_torch.tools.stack_factor import jacobi, spd_stack

    summary = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for label, (B, n) in STACK_CHOL_SHAPES.items():
            A = spd_stack(B, n, dtype, seed=n, device=device)
            d = jacobi(A)
            ops.reset_launches()
            L, info = stack_cholesky(A, d)
            torch.cuda.synchronize()
            got = ops.launch_counts()["stack_cholesky"]
            shape = schedule(n, dtype)
            Hs = A * d[:, :, None] * d[:, None, :]
            Lp, info_p = stack_cholesky_plain(Hs)
            if info.tolist() != [0] * B or info_p.tolist() != [0] * B:
                raise AssertionError(f"stack_cholesky {label} {name}: info "
                                     f"{info.tolist()}, loop "
                                     f"{info_p.tolist()}")
            if got != shape.launches(n) or not L.mT.is_contiguous():
                raise AssertionError(f"stack_cholesky {label} {name}: "
                                     f"{got} launches, contiguous "
                                     f"{L.mT.is_contiguous()}")
            if not bool((torch.triu(L, 1) == 0).all()):
                raise AssertionError(f"stack_cholesky {label} {name}: "
                                     "strict upper triangle not 0")
            H64 = Hs.double()
            rk = max((L[k].double() @ L[k].double().mT - H64[k]).abs()
                     .max().item() for k in range(B))
            rp = max((Lp[k].double() @ Lp[k].double().mT - H64[k]).abs()
                     .max().item() for k in range(B))
            del H64
            alone = all(torch.equal(L[k], stack_cholesky(
                A[k:k + 1], d[k:k + 1])[0][0]) for k in (0, B - 1))
            floor = 4 * torch.finfo(dtype).eps
            log("kernels", kernel="stack_cholesky", shape=label, dtype=name,
                batch=json.dumps([B, n, n]),
                schedule=json.dumps(shape._asdict()), launches=got,
                resid_kernel=rk, resid_loop=rp, bitwise_alone=alone)
            if not (np.isfinite(rk) and rk <= max(RESID_FACTOR * rp, floor)):
                raise AssertionError(f"stack_cholesky {label} {name}: "
                                     f"residual {rk} > {RESID_FACTOR} x the "
                                     f"cuSOLVER loop's {rp}")
            if not alone:
                raise AssertionError(f"stack_cholesky {label} {name}: a "
                                     "lane differs from its matrix alone")
            if dtype == torch.float32:
                timings.append(functools.partial(
                    time_stack_chol, A, d, label, rk, peaks,
                    summary if label == "dense_intel50_sc" else None))
            del L, Lp, Hs
    return summary


def check_folded(device, A, lead: tuple, chains=None) -> float:
    """``micro_chol_inv_folded`` held to the plain version of the flat
    batch: on the ``(*lead, M / prod(lead), 128, 128)`` view of the SPD
    panels ``A``; with ``chains`` (the chain batch of ``A``'s dtype: 6
    chains x 16 interiors under the first round's masks), also on the
    seed batch's real first and trailing panels (8 seeds x 16 interiors,
    folded over the seeds) and on those of ``chains``.  Returns the
    largest error."""
    from slam_tpu_torch.tools.problems import intel50_seed_batch

    name = str(A.dtype).replace("torch.", "")
    errs = [check_chol(f"spd{A.shape[0]}", A, name, "spd", lead=lead)]
    if chains is None:
        return errs[0]
    b = intel50_seed_batch(device, A.dtype).batch
    poses, _, edges, free = chains.flat_args
    for label, lanes, args in (
            ("seed-batch", b.seeds, (b.edges, b.free,
                                     b.poses0.reshape(-1, 3), b.partition)),
            ("chain-batch", chains.chains.chains,
             (edges, free, poses, chains.chains.partition))):
        panels = real_panels(*args)
        log("kernels", panels=label, dtype=name, lanes=lanes,
            blocks=args[3].num_blocks, interior_dim=panels["n"],
            padded=panels["n_pad"])
        for which in ("first", "trailing"):
            errs.append(check_chol(f"{label}-{which}", panels[which],
                                   name, "residual", lead=(lanes,)))
    return max(errs)


def check_chain_batches(device, dtype):
    """Phase 2 on the rescue's chain batch (see the module docstring): one
    batched iteration on the Schur solver (native; in float32 also blocked
    with the kernel) and on the dense solver, through
    :func:`check_short_solves`.  Returns the Schur case."""
    from slam_tpu_torch.tools.problems import CONFIGS, intel50_chains

    name = str(dtype).replace("torch.", "")
    schur = intel50_chains(device, name)
    dense = intel50_chains(device, name, "dense", masks=schur.masks)
    cfg = schur.prob.scfg
    runs = {"schur": cfg}
    if dtype == torch.float32:
        runs["blocked"] = cfg.replace(**CONFIGS["blocked_micro"])
    for kind, c in runs.items():
        check_short_solves("INTEL-chains", c, schur.chains.partition,
                           {kind: schur.flat_args}, dtype)
    check_short_solves("INTEL-chains", dense.prob.scfg,
                       dense.chains.partition, {"dense": dense.flat_args},
                       dtype)
    check_lane_batches(device, dtype, schur.masks)
    return schur


@functools.lru_cache(maxsize=None)
def sc_case(device, solver: str, dtype):
    """The joint-SC seed batch on ``solver`` (a ``problems.BatchCase``)."""
    from slam_tpu_torch.tools.problems import intel50_seed_batch

    return intel50_seed_batch(device, dtype, solver, "sc")


def check_sc_batch(device, dtype) -> None:
    """Phase 2 on the joint-SC seed batch of [sc_batch]: one batched
    iteration on the Schur solver (native; in float32 also blocked with
    the kernel) and on the dense joint solver, every gather and scatter
    launch replayed through :func:`check_launches`, the fused
    linearisation not launched (joint SC takes the plain chain); and
    ``micro_chol_inv_folded`` on the batch's real first and trailing
    panels of the system with the switches eliminated (8 seeds x 16
    interiors, folded over the seeds), after ``SC_PANEL_ITERS`` batched
    iterations: at the start no bogus loop lies inside an interior and
    every switch is 1, so the panels are the DCS seed batch's."""
    from slam_tpu_torch.solver.batch import lm_fixed_iters_batch
    from slam_tpu_torch.tools import kernel_times as kt
    from slam_tpu_torch.tools.problems import SC_BATCH_CONFIGS

    name = str(dtype).replace("torch.", "")
    kinds = ["native", "dense"] + (["blocked_micro"]
                                   if dtype == torch.float32 else [])
    for kind in kinds:
        solver, kw = SC_BATCH_CONFIGS[kind]
        c = sc_case(device, solver, dtype)
        b = c.batch
        args = (b.poses0.reshape(-1, b.poses0.shape[-1]),
                b.switches0.reshape(-1), b.edges, b.free)
        calls, counts, _ = kt.record_iteration(args, c.cfg.replace(**kw),
                                               c.plan)
        label = f"INTEL-sc-seeds-{kind}"
        required = PHASE_KERNELS[f"sc_batch_{kind}"]
        if any(counts.get(k, 0) <= 0 for k in required) or counts.get(
                "fused_linearize_se2", 0):
            raise AssertionError(f"{label} {name}: launches {counts}, "
                                 f"required {required}, no "
                                 "fused_linearize_se2")
        log("kernels", shape=label, dtype=name, lanes=b.seeds,
            edges=b.edges.num_edges, nodes=b.edges.num_nodes,
            checked_calls=len(calls),
            scatter_max_abs_err=check_launches(calls, label, name),
            launches_per_run=json.dumps(counts))
    c = sc_case(device, "schur", dtype)
    b = c.batch
    res = lm_fixed_iters_batch(*b.args, c.cfg, SC_PANEL_ITERS,
                               partition=c.plan)
    panels = real_panels(b.edges, b.free,
                         res.poses.reshape(-1, b.poses0.shape[-1]), c.plan,
                         robust="sc", switches=res.switches.reshape(-1))
    log("kernels", panels="sc-seed-batch", dtype=name, lanes=b.seeds,
        iters=SC_PANEL_ITERS, blocks=c.plan.num_blocks,
        interior_dim=panels["n"], padded=panels["n_pad"])
    for which in ("first", "trailing"):
        check_chol(f"sc-seed-batch-{which}", panels[which], name,
                   "residual", lead=(b.seeds,))


def check_lane_batches(device, dtype, masks) -> None:
    """Phase 2 on the PCG and Woodbury batches: one batched iteration of
    the rescue's chain batch under ``masks`` and of the seed batch of
    ``scripts/bench_pcg.py`` / ``bench_woodbury.py``, each on both
    solvers (PCG cut to 3 CG iterations), through
    :func:`check_short_solves`."""
    from slam_tpu_torch.tools.problems import intel50_chains, \
        intel50_seed_batch

    name = str(dtype).replace("torch.", "")
    for solver in ("pcg", "woodbury"):
        c = intel50_chains(device, name, solver, masks=masks)
        s = intel50_seed_batch(device, dtype, solver)
        b = s.batch
        seeds = (b.poses0.reshape(-1, b.poses0.shape[-1]),
                 b.switches0.reshape(-1), b.edges, b.free)
        for label, cfg, plan, args in (
                ("INTEL-chains", c.prob.scfg, c.chains.partition,
                 c.flat_args),
                ("INTEL-seeds", s.cfg, s.plan, seeds)):
            check_short_solves(label, cfg.replace(pcg_max_iters=3), plan,
                               {solver: args}, dtype)


def run_cli_path(phase: str, run) -> tuple[dict, float, np.ndarray]:
    """Drive a path with the launch counts set to 0 just before and read
    just after; returns (counts, wall seconds, optimised poses)."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.io import g2o

    with tempfile.TemporaryDirectory() as save:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(save)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for fname in ("init_nodes.txt", "init_edges.txt", "opt_nodes.txt",
                      "opt_edges.txt"):
            if not os.path.isfile(os.path.join(save, fname)):
                raise AssertionError(f"{phase} wrote no {fname}")
        poses = g2o.load_nodes(os.path.join(save, "opt_nodes.txt"))
    return counts, wall, poses


def golden_ate(phase: str, poses) -> float:
    from slam_tpu_torch.eval import metrics

    golden = np.load(os.path.join(REPO, "results", "golden",
                                  "INTEL_50out_seed42.npy"))
    if poses.shape != golden.shape or not np.isfinite(poses).all():
        raise AssertionError(f"{phase}: opt_nodes shape {poses.shape} or "
                             "non-finite")
    return metrics.ate(poses, golden)


@contextlib.contextmanager
def rescue_rounds(rounds: list):
    """Append each consensus round's batched solve of the run inside to
    ``rounds``: each lane's iterations, as a tensor (no host read while
    the run goes on)."""
    from slam_tpu_torch.solver import batch

    solve = batch.lm_solve_batch

    def recorded(*args, **kw):
        res = solve(*args, **kw)
        rounds.append(res.iterations)
        return res

    batch.lm_solve_batch = recorded
    try:
        yield rounds
    finally:
        batch.lm_solve_batch = solve


def round_fields(rounds: list) -> dict:
    """The lanes and the batched iterations of each round."""
    return dict(
        rounds=len(rounds),
        lanes_per_round=json.dumps([int(it.numel()) for it in rounds]),
        batched_iterations=json.dumps([int(it.max()) for it in rounds]),
        lane_iterations=json.dumps([it.tolist() for it in rounds]))


def run_rescue_cli(phase: str, argv: list) -> tuple[dict, float, np.ndarray]:
    """``run_cli_path`` of ``cli.main(argv + ["--save-path", DIR])`` with
    its consensus rounds recorded into ``RESCUE_RUNS[phase]``."""
    from slam_tpu_torch import cli

    rounds = []

    def run(save):
        with rescue_rounds(rounds):
            rc = cli.main(argv + ["--save-path", save])
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        RESCUE_RUNS[phase] = {"rounds": rounds, "solve": log_record(
            os.path.join(save, "method1.log"), "solve")}

    return run_cli_path(phase, run)


def phase_main_path() -> dict:
    counts, wall, poses = run_rescue_cli(
        "main_path", ["INTEL", "50", "1", "--seed", "42"])
    ate = golden_ate("main_path", poses)
    MAIN_RUN.update(poses=poses, ate=ate, launches=counts,
                    solve=RESCUE_RUNS["main_path"]["solve"])
    log("main_path", wall_s=round(wall, 3), ate_vs_golden_m=ate,
        launches=json.dumps(counts))
    if not ate < ATE_GATE_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_GATE_M} m")
    require_launches("main_path", counts)
    return counts


def reference_cost() -> dict:
    return reference("intel50_plain_dcs_lm_fixed_iters")


def timed_lm(args, cfg, iters: int, part) -> tuple:
    """(result, wall seconds, launch counts, final cost) of ``iters`` LM
    iterations in one call."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.solver.lm import lm_fixed_iters

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = lm_fixed_iters(*args, cfg, iters, partition=part)
    cost = float(res.cost)  # synchronises
    return res, time.perf_counter() - t0, ops.launch_counts(), cost


def phase_plain_dcs(device, smi: str) -> None:
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.tools.problems import intel50_plain_dcs

    ref = reference_cost()
    prob = intel50_plain_dcs(device, "float32")
    iters = ref["iterations"]
    args = (prob.poses0, prob.switches0, prob.edges, prob.free)
    lm_fixed_iters(*args, prob.scfg, 2, partition=prob.partition)  # warm-up
    res, wall, counts, cost = timed_lm(args, prob.scfg, iters,
                                       prob.partition)
    rel = abs(cost - ref["final_cost"]) / abs(ref["final_cost"])
    log("plain_dcs", initial_cost=float(res.initial_cost), final_cost=cost,
        reference_f64=ref["final_cost"], rel_diff=rel,
        accepted=int(res.accepted), iters=iters, wall_s=round(wall, 4),
        lm_it_per_s=round(iters / wall, 2),
        launches_per_iter=json.dumps({k: n / iters
                                      for k, n in counts.items()}),
        card=json.dumps(smi))
    if not rel <= REF_COST_RTOL:
        raise AssertionError(f"plain DCS cost {cost} vs reference "
                             f"{ref['final_cost']}: rel {rel}")


def phase_scale(device, smi: str) -> None:
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.tools.problems import m10000

    t0 = time.perf_counter()
    m = m10000(device, torch.float32)
    setup = time.perf_counter() - t0
    args, cfg, part = m.args, m.cfg, m.partition
    lm_fixed_iters(*args, cfg, 2, partition=part)
    iters = 50
    res, wall, _, cost = timed_lm(args, cfg, iters, part)
    cost0 = float(res.initial_cost)
    log("scale", nodes=m.graph.num_nodes, edges=args[2].num_edges,
        blocks=part.num_blocks, scheme="graph" if m.spectral else "index",
        ni_max=part.ni_max, ns=part.ns, nsk_max=part.nsk_max,
        setup_s=round(setup, 3), initial_cost=cost0, final_cost=cost,
        accepted=int(res.accepted), iters=iters, wall_s=round(wall, 4),
        lm_it_per_s=round(iters / wall, 3), card=json.dumps(smi))
    if not (np.isfinite(cost) and cost <= SCALE_COST_FRAC * cost0):
        raise AssertionError(f"M10000 cost {cost} > {SCALE_COST_FRAC} x "
                             f"{cost0}")


def lm_in_turns(tag: str, label: str, args, base, part, iters: int,
                smi: str) -> dict:
    """``iters`` LM iterations of one case under each Schur factorisation
    (``CONFIGS``), after a warm-up of each, timed in turns (a, b, c, c, b,
    a); one ``[tag]`` line per factorisation.  Returns ``{factorisation:
    [(result, wall, launch counts, cost)] * 2}``."""
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.tools.problems import CONFIGS

    for kw in CONFIGS.values():  # warm-up of each configuration
        lm_fixed_iters(*args, base.replace(**kw), 2, partition=part)
    runs = {k: [] for k in CONFIGS}
    for name in list(CONFIGS) + list(CONFIGS)[::-1]:
        runs[name].append(timed_lm(args, base.replace(**CONFIGS[name]),
                                   iters, part))
    for name, rs in runs.items():
        res, _, counts, cost = rs[0]
        walls = [r[1] for r in rs]
        if any(r[3] != cost for r in rs):
            raise AssertionError(f"{label} {name}: the two runs differ")
        log(tag, shape=label, config=name, final_cost=cost,
            initial_cost=float(res.initial_cost),
            accepted=int(res.accepted), iters=iters,
            wall_s=json.dumps([round(w, 4) for w in walls]),
            lm_it_per_s=round(iters * len(walls) / sum(walls), 2),
            launches_per_iter=json.dumps(
                {k: n / iters for k, n in counts.items()}),
            card=json.dumps(smi))
    return runs


def phase_blocked(device, smi: str) -> dict:
    """Phase 6; returns the launch counts of the blocked INTEL path."""
    from slam_tpu_torch.config import RunConfig, SolverConfig
    from slam_tpu_torch.methods.global_solve import run_from_config
    from slam_tpu_torch.tools.problems import CONFIGS, intel50_plain_dcs, \
        m10000

    # (a) the blocked configuration through the pipeline, rescue on.
    rounds = []

    def run(save):
        with rescue_rounds(rounds):
            run_from_config(RunConfig(
                dataset="INTEL", num_outliers=50, method=1, seed=42,
                save_path=save, solver=SolverConfig(
                    dtype="float32", **CONFIGS["blocked_micro"])),
                device=device)
        RESCUE_RUNS["blocked_path"] = {"rounds": rounds, "solve": log_record(
            os.path.join(save, "method1.log"), "solve")}

    path_counts, wall, poses = run_cli_path("blocked_path", run)
    ate = golden_ate("blocked_path", poses)
    log("blocked_path", wall_s=round(wall, 3), ate_vs_golden_m=ate,
        micro_chol_inv_launches=path_counts["micro_chol_inv"],
        launches=json.dumps(path_counts))
    if not ate < ATE_GATE_M:
        raise AssertionError(f"blocked path ATE {ate} m >= {ATE_GATE_M} m")
    require_launches("blocked_path", path_counts)

    # (b)-(d): plain DCS on INTEL and M10000, 50 iterations in one call,
    # under each factorisation, timed in turns.
    ref = reference_cost()
    iters = ref["iterations"]
    prob = intel50_plain_dcs(device, "float32")
    m = m10000(device, torch.float32)
    cases = {
        "INTEL": ((prob.poses0, prob.switches0, prob.edges, prob.free),
                  prob.scfg, prob.partition),
        "M10000": (m.args, m.cfg, m.partition),
    }
    for label, (args, base, part) in cases.items():
        runs = lm_in_turns("blocked_ab", label, args, base, part, iters, smi)
        native = {k: n / iters for k, n in runs["native"][0][2].items()}
        over = {k: v for k, v in native.items()
                if v > LAUNCH_LIMITS.get(k, float("inf"))}
        if label == "INTEL" and over:
            raise AssertionError(f"INTEL native launches per iteration "
                                 f"{over} above {LAUNCH_LIMITS}")
        res, _, counts, cost = runs["blocked_micro"][0]
        if counts["micro_chol_inv"] <= 0:
            raise AssertionError(f"{label}: blocked_micro launched no "
                                 "micro_chol_inv")
        if label == "INTEL":  # (b)
            rel = abs(cost - ref["final_cost"]) / abs(ref["final_cost"])
            log("blocked_plain_dcs", final_cost=cost,
                reference_f64=ref["final_cost"], rel_diff=rel,
                gate=BLOCKED_REF_COST_RTOL)
            if not rel <= BLOCKED_REF_COST_RTOL:
                raise AssertionError(
                    f"blocked plain DCS cost {cost} vs reference "
                    f"{ref['final_cost']}: rel {rel}")
        else:  # (c)
            cost0 = float(res.initial_cost)
            log("blocked_scale", initial_cost=cost0, final_cost=cost,
                gate_frac=SCALE_COST_FRAC)
            if not (np.isfinite(cost) and cost <= SCALE_COST_FRAC * cost0):
                raise AssertionError(f"blocked M10000 cost {cost} > "
                                     f"{SCALE_COST_FRAC} x {cost0}")
    return path_counts


def timed_batch(case, cfg, iters: int) -> tuple:
    """(result, wall seconds, launch counts, costs, peak bytes) of
    ``iters`` batched iterations of ``case`` (a ``problems.BatchCase``)
    on its plan in one call; the peak counts the bytes allocated above
    those held when the run starts."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.solver.batch import lm_fixed_iters_batch

    b = case.batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = lm_fixed_iters_batch(*b.args, cfg, iters, partition=case.plan)
    costs = res.cost.tolist()  # synchronises
    return (res, time.perf_counter() - t0, ops.launch_counts(), costs,
            torch.cuda.max_memory_allocated() - held)


def timed_alone(case, cfg, iters: int) -> tuple:
    """(results, total wall seconds, each seed's launch counts, costs,
    peak bytes as :func:`timed_batch` counts them) of each seed alone,
    one after another."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out, wall, counts = [], 0.0, []
    for args, part in case.alone:
        res, w, c, cost = timed_lm(args, cfg, iters, part)
        out.append((res, cost))
        wall += w
        counts.append(c)
    return (out, wall, counts, [c for _, c in out],
            torch.cuda.max_memory_allocated() - held)


def batch_device_ms(run, wall_ms: float,
                    n: int = SEED_BATCH_PROFILE_ITERS) -> dict:
    """Device ms and busy share per batched iteration: the kernels'
    device events under torch.profiler over ``run(n)``, ``n`` batched
    iterations, against the unprofiled wall per iteration."""
    from torch.profiler import ProfilerActivity, profile

    from slam_tpu_torch.tools.profile_lm import device_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    dev = sum(device_us(e) for e in events) / 1e3 / n
    return {"device_ms_per_iter": dev, "busy_share": dev / wall_ms,
            "device_launches_per_iter": sum(e.count for e in events) / n}


def phase_seed_batch(device, smi: str, timings: list) -> dict:
    """Phase 6e: the seed batch against each seed alone, under the three
    factorisations; returns each configuration's batch launch counts.
    Its device times are appended to ``timings`` (profiler last)."""
    from slam_tpu_torch.solver.batch import lm_fixed_iters_batch
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.tools.problems import BATCH_BLOCKS, BATCH_ITERS, \
        CONFIGS, intel50_seed_batch

    t0 = time.perf_counter()
    case = intel50_seed_batch(device, torch.float32)
    case64 = intel50_seed_batch(device, torch.float64)
    b, iters = case.batch, BATCH_ITERS
    B = b.seeds
    part = b.partition
    log("seed_batch", seeds=B, nodes=b.poses0.shape[1],
        edges_per_seed=b.switches0.shape[1], blocks=BATCH_BLOCKS,
        pad_shapes=json.dumps(list(b.pad_shapes)),
        interiors=part.num_blocks, interior_dim=part.ni_max * 3,
        separator_dim=part.ns * 3, setup_s=round(time.perf_counter() - t0, 3))

    # The batch against each seed alone: float32, one iteration, all three
    # factorisations; float64, all the iterations, native and blocked-plain.
    # The float64 native batch is the float32 batch's reference below.
    checks = [(case, name, 1, SEED_BATCH_STEP_RTOL,
               SEED_BATCH_STEP_POSE_ATOL) for name in CONFIGS]
    checks += [(case64, name, iters, SEED_BATCH_F64_RTOL,
                SEED_BATCH_F64_POSE_ATOL)
               for name in ("native", "blocked_plain")]
    for c, name, n, rtol, atol in checks:
        res, rel, dp, _, _ = lanes_alone(c, c.cfg.replace(**CONFIGS[name]),
                                         n)
        if c is case64 and name == "native":
            ref64 = res.cost.tolist()
        dtype = str(c.batch.poses0.dtype).replace("torch.", "")
        log("seed_batch", held=name, dtype=dtype, iters=n,
            rel_diff=json.dumps(rel), pose_diff_m=json.dumps(dp),
            gate_rel=rtol, gate_pose_m=atol)
        if not (max(rel) <= rtol and max(dp) <= atol):
            raise AssertionError(f"seed_batch {name} {dtype} {n} "
                                 f"iterations: batch vs alone rel "
                                 f"{max(rel)}, poses {max(dp)} m")

    out, walls_ms = {}, {}
    for name, kw in CONFIGS.items():
        cfg = case.cfg.replace(**kw)
        lm_fixed_iters_batch(*b.args, cfg, 2, partition=part)  # warm-up
        for args, p in case.alone:
            lm_fixed_iters(*args, cfg, 2, partition=p)
        runs = [timed_batch(case, cfg, iters), timed_alone(case, cfg, iters),
                timed_alone(case, cfg, iters), timed_batch(case, cfg, iters)]
        batch, alone = runs[0], runs[1]
        if runs[3][3] != batch[3] or runs[2][3] != alone[3]:
            raise AssertionError(f"seed_batch {name}: two runs differ")
        res, counts = batch[0], batch[2]
        costs, costs0 = batch[3], res.initial_cost.tolist()
        rel = [abs(c - a) / abs(a) for c, a in zip(costs, alone[3])]
        rel64 = [abs(c - r) / abs(r) for c, r in zip(costs, ref64)]
        bitwise = [bool(torch.equal(res.poses[i], r.poses))
                   and costs[i] == a for i, ((r, _), a)
                   in enumerate(zip(alone[0], alone[3]))]
        batch_wall = (runs[0][1] + runs[3][1]) / 2
        alone_wall = (runs[1][1] + runs[2][1]) / 2
        walls_ms[name] = batch_wall * 1e3 / iters
        per_iter = {k: n / iters for k, n in counts.items()}
        log("seed_batch", config=name, iters=iters,
            batch_wall_s=json.dumps([round(runs[0][1], 4),
                                     round(runs[3][1], 4)]),
            lm_it_per_s=round(B * iters / batch_wall, 2),
            alone_total_wall_s=json.dumps([round(runs[1][1], 4),
                                           round(runs[2][1], 4)]),
            alone_lm_it_per_s=round(B * iters / alone_wall, 2),
            batch_ms_per_iter=round(walls_ms[name], 4),
            peak_bytes_batch=batch[4], peak_bytes_alone=alone[4],
            costs=json.dumps(costs), initial_costs=json.dumps(costs0),
            alone_costs=json.dumps(alone[3]), rel_diff=json.dumps(rel),
            bitwise_equal=json.dumps(bitwise),
            f64_costs=json.dumps(ref64), rel_to_f64=json.dumps(rel64),
            gate_rel_to_f64=SEED_BATCH_F32_RTOL[name],
            accepted=json.dumps(res.accepted.tolist()),
            launches_per_iter=json.dumps(per_iter), card=json.dumps(smi))
        bad = [i for i, (c, c0) in enumerate(zip(costs, costs0))
               if not (c0 > SEED_BATCH_COST0_MIN
                       and c < SEED_BATCH_COST_FRAC * c0)]
        if bad:
            raise AssertionError(f"seed_batch {name}: seeds {bad} miss "
                                 "bench.py's gate")
        if max(rel64) > SEED_BATCH_F32_RTOL[name]:
            raise AssertionError(
                f"seed_batch {name}: float32 cost {max(rel64)} from the "
                f"float64 batch's, above {SEED_BATCH_F32_RTOL[name]}")
        for i, c in enumerate(alone[2]):
            diff = {k: (counts[k], c[k]) for k in PHASE_KERNELS[
                "seed_batch_blocked_micro"] if counts[k] != c[k]}
            if diff:
                raise AssertionError(f"seed_batch {name}: launches of the "
                                     f"batch vs seed {i} alone: {diff}")
        require_launches(f"seed_batch_{name}", counts)
        out[f"seed_batch_{name}"] = counts

    def device_times():  # profiled in the report, after every other time
        for name, kw in CONFIGS.items():
            log("seed_batch", config=name, **batch_device_ms(
                lambda n, cfg=case.cfg.replace(**kw): lm_fixed_iters_batch(
                    *b.args, cfg, n, partition=part), walls_ms[name]),
                wall_ms_per_iter=walls_ms[name], card=json.dumps(smi))

    timings.append(lambda: ([], [], device_times))
    return out


def iteration_launches(run) -> dict:
    """Kernel launches of one LM iteration: those of ``run(2)`` (two
    iterations) less those of ``run(1)``."""
    from slam_tpu_torch import ops

    counts = []
    for n in (1, 2):
        torch.cuda.synchronize()
        ops.reset_launches()
        run(n)
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
    return {k: counts[1][k] - counts[0][k] for k in counts[0]}


def phase_rescue_batch(device, smi: str, timings: list) -> dict:
    """Phase 6f; returns the launch counts of the float64 batched solve of
    (a) and of the dense CLI run of (c).  The device times of (d) are
    appended to ``timings`` (profiler last)."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.solver.batch import lane, lm_solve_batch
    from slam_tpu_torch.solver.lm import lm_solve
    from slam_tpu_torch.tools.problems import CONFIGS, intel50_chains

    # (a) float64: the first round, each lane against its chain alone.
    t0 = time.perf_counter()
    case = intel50_chains(device, "float64")
    prob, ch = case.prob, case.chains
    cfg, part = prob.scfg, ch.partition
    setup = time.perf_counter() - t0
    lm_solve_batch(*case.args, cfg.replace(max_iterations=2), part)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = lm_solve_batch(*case.args, cfg, part)
    iters = res.iterations.tolist()  # synchronises
    batch_wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rel, dp, same, alone_wall = [], [], [], 0.0
    for c in range(ch.chains):
        es = prob.edges._replace(active=torch.as_tensor(
            case.masks[c], dtype=prob.poses0.dtype, device=device))
        t0 = time.perf_counter()
        r = lm_solve(prob.poses0, prob.switches0, es, prob.free, cfg,
                     partition=prob.partition)
        cost = float(r.cost)  # synchronises
        alone_wall += time.perf_counter() - t0
        got = lane(res, c)
        rel.append(abs(float(got.cost) - cost) / abs(cost))
        dp.append(float((got.poses - r.poses).abs().max()))
        same.append([int(got.iterations), int(got.accepted),
                     bool(got.converged)] == [int(r.iterations),
                                              int(r.accepted),
                                              bool(r.converged)])
    per_batch = iteration_launches(lambda n: lm_solve_batch(
        *case.args, cfg.replace(max_iterations=n), part))
    per_chain = iteration_launches(lambda n: lm_solve(
        prob.poses0, prob.switches0, es, prob.free,
        cfg.replace(max_iterations=n), partition=prob.partition))
    log("rescue_batch", dtype="float64", chains=ch.chains,
        edges=ch.edges.num_edges, nodes=ch.edges.num_nodes,
        interiors=part.num_blocks, separators=part.seeds,
        setup_s=round(setup, 3), lane_iterations=json.dumps(iters),
        accepted=json.dumps(res.accepted.tolist()),
        converged=json.dumps(res.converged.tolist()),
        batch_wall_s=round(batch_wall, 4),
        chains_alone_wall_s=round(alone_wall, 4),
        rel_diff=json.dumps(rel), pose_diff_m=json.dumps(dp),
        same_counts=json.dumps(same), gate_rel=RESCUE_F64_RTOL,
        gate_pose_m=RESCUE_F64_POSE_ATOL,
        launches_per_batched_iter=json.dumps(per_batch),
        launches_per_chain_iter=json.dumps(per_chain), card=json.dumps(smi))
    if not (all(same) and max(rel) <= RESCUE_F64_RTOL
            and max(dp) <= RESCUE_F64_POSE_ATOL):
        raise AssertionError(f"rescue_batch: lanes vs chains alone: counts "
                             f"equal {same}, rel {max(rel)}, poses "
                             f"{max(dp)} m")
    over = {k: v for k, v in per_batch.items()
            if v > LAUNCH_LIMITS.get(k, float("inf"))}
    if per_batch != per_chain or over:
        raise AssertionError(f"rescue_batch: launches per batched iteration "
                             f"{per_batch}, per chain {per_chain}, limits "
                             f"{LAUNCH_LIMITS}")
    require_launches("rescue_batch", counts)

    # (b) the rounds of the runs through the rescue.
    for phase in ("main_path", "blocked_path"):
        run = RESCUE_RUNS[phase]
        log("rescue_batch", run=phase, **round_fields(run["rounds"]),
            solve_wall_s=run["solve"]["wall_s"],
            final_cost=run["solve"]["final_cost"], card=json.dumps(smi))

    # (c) the chains on the batched dense solver, through the CLI.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dense_counts, wall, poses = run_rescue_cli(
        "rescue_batch_dense", ["INTEL", "50", "1", "--seed", "42",
                               "--linear-solver", "dense"])
    peak = torch.cuda.max_memory_allocated()
    ate = golden_ate("rescue_batch_dense", poses)
    run = RESCUE_RUNS["rescue_batch_dense"]
    log("rescue_batch", run="dense_cli", wall_s=round(wall, 3),
        solve_wall_s=run["solve"]["wall_s"],
        final_cost=run["solve"]["final_cost"], ate_vs_golden_m=ate,
        peak_allocated_bytes=peak, peak_above_held_bytes=peak - held,
        **round_fields(run["rounds"]), launches=json.dumps(dense_counts),
        card=json.dumps(smi))
    if not ate < ATE_GATE_M:
        raise AssertionError(f"dense CLI ATE {ate} m >= {ATE_GATE_M} m")
    if not run["rounds"]:
        raise AssertionError("dense CLI: no batched consensus round")
    require_launches("rescue_batch_dense", dense_counts)

    # (d) float32: the first round's batched solve on the Schur solver
    # (native, and blocked with the kernel on its 96 folded panels) and
    # the dense solver, its wall and launches per batched iteration; its
    # device time and busy share under the profiler, after every other
    # time.
    schur = intel50_chains(device, "float32")
    dense = intel50_chains(device, "float32", "dense", masks=schur.masks)
    cases = {"schur": (schur, schur.prob.scfg),
             "blocked_micro": (schur, schur.prob.scfg.replace(
                 **CONFIGS["blocked_micro"])),
             "dense": (dense, dense.prob.scfg)}
    walls_ms = {}
    for name, (c, cfg) in cases.items():
        part = c.chains.partition
        lm_solve_batch(*c.args, cfg.replace(max_iterations=2), part)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = lm_solve_batch(*c.args, cfg, part)
        n = int(res.iterations.max())  # synchronises
        wall = time.perf_counter() - t0
        walls_ms[name] = wall * 1e3 / n
        log("rescue_batch", dtype="float32", solver=name,
            lane_iterations=json.dumps(res.iterations.tolist()),
            batched_iterations=n, wall_s=round(wall, 4),
            ms_per_batched_iter=round(walls_ms[name], 4),
            launches_per_batched_iter=json.dumps(
                {k: v / n for k, v in ops.launch_counts().items()}),
            card=json.dumps(smi))

    def device_times():  # profiled in the report, after every other time
        for name, (c, cfg) in cases.items():
            log("rescue_batch", dtype="float32", solver=name,
                **batch_device_ms(lambda n, c=c, cfg=cfg: lm_solve_batch(
                    *c.args, cfg.replace(max_iterations=n),
                    c.chains.partition), walls_ms[name]),
                wall_ms_per_iter=walls_ms[name], card=json.dumps(smi))

    timings.append(lambda: ([], [], device_times))
    return {"rescue_batch": counts, "rescue_batch_dense": dense_counts}


@contextlib.contextmanager
def cg_counts(out: list):
    """Append each ``pcg_solve`` call's CG count (a (B,) tensor in a batch,
    0-d alone) of the run inside to ``out``, left on the device, and one
    ``None`` per matvec: per iteration the CG loop ran, those after its
    lanes stopped and before its next host check included."""
    from slam_tpu_torch.solver import linear

    solve, matvec = linear.pcg_solve, linear.matvec

    def recorded(*args, **kw):
        dx, iters = solve(*args, **kw)
        out.append(iters)
        return dx, iters

    def counted(*args, **kw):
        out.append(None)
        return matvec(*args, **kw)

    linear.pcg_solve, linear.matvec = recorded, counted
    try:
        yield out
    finally:
        linear.pcg_solve, linear.matvec = solve, matvec


def cg_fields(counts: list, launches: dict) -> dict:
    """The CG iterations of the recorded calls: each call's slowest lane
    (``batched_cg_iterations``), the lanes' sum, and the iterations the
    loop ran (``loop_cg_iterations``), with the launches per loop
    iteration."""
    its = [c for c in counts if c is not None]
    loop = len(counts) - len(its)
    return {"batched_cg_iterations": sum(int(c.max()) for c in its),
            "lane_cg_iterations": sum(int(c.sum()) for c in its),
            "loop_cg_iterations": loop,
            "launches_per_loop_cg_iter": json.dumps(
                {k: v / loop for k, v in launches.items()})}


def chain_lanes(phase: str, solver: str, masks, device, smi: str,
                cap: int | None) -> dict:
    """(a) of [pcg_batch] and [woodbury_batch]: float64, the rescue's first
    round of INTEL+50 seed 42 (its six chains under ``masks``, the masks
    the Schur rescue builds from its plain solve) on ``solver``, capped
    at ``cap`` LM iterations (None: to convergence).  The batched
    ``lm_solve`` and the chains alone one after another (the parent's
    loop), in turns (batch, chains, chains, batch); each lane held to its
    chain alone at the [rescue_batch] gates with equal iterations,
    accepted steps, convergence and CG counts; the launches of a batched
    iteration equal to one chain's (PCG: every CG run to
    ``PCG_FIXED_CG``), and on PCG at most ``PCG_LAUNCH_LIMIT`` gathers and
    scatters an iteration of the CG loop.  Returns the batched run's
    launch counts."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.solver.batch import lane, lm_solve_batch
    from slam_tpu_torch.solver.lm import lm_solve
    from slam_tpu_torch.tools.problems import intel50_chains

    t0 = time.perf_counter()
    case = intel50_chains(device, "float64", solver, masks=masks)
    prob, ch = case.prob, case.chains
    cfg = prob.scfg if cap is None else prob.scfg.replace(max_iterations=cap)
    part = ch.partition
    alone_edges = [prob.edges._replace(active=torch.as_tensor(
        m, dtype=prob.poses0.dtype, device=device)) for m in case.masks]
    setup = time.perf_counter() - t0

    def batch():
        cg = []
        with cg_counts(cg):
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            res = lm_solve_batch(*case.args, cfg, part)
            res.iterations.tolist()  # synchronises
            wall = time.perf_counter() - t0
        return res, wall, ops.launch_counts(), cg

    def chains():
        out, t0 = [], time.perf_counter()
        for es in alone_edges:
            out.append(lm_solve(prob.poses0, prob.switches0, es, prob.free,
                                cfg, partition=prob.partition))
        float(out[-1].cost)  # synchronises
        return out, time.perf_counter() - t0

    lm_solve_batch(*case.args, cfg.replace(max_iterations=1), part)
    lm_solve(prob.poses0, prob.switches0, alone_edges[0], prob.free,
             cfg.replace(max_iterations=1), partition=prob.partition)
    b1, c1, c2, b2 = batch(), chains(), chains(), batch()
    res, counts, cg = b1[0], b1[2], b1[3]
    rel, dp, same = [], [], []
    for c, r in enumerate(c1[0]):
        got = lane(res, c)
        rel.append(abs(float(got.cost) - float(r.cost)) / abs(float(r.cost)))
        dp.append(float((got.poses - r.poses).abs().max()))
        same.append([int(got.iterations), int(got.accepted),
                     bool(got.converged), int(got.lin_iters)]
                    == [int(r.iterations), int(r.accepted),
                        bool(r.converged), int(r.lin_iters)])
    bitwise = [bool(torch.equal(lane(res, c).poses, r.poses))
               for c, r in enumerate(c1[0])]
    fixed = cfg.replace(pcg_rtol=0.0, pcg_max_iters=PCG_FIXED_CG) \
        if solver == "pcg" else cfg
    per_batch = iteration_launches(lambda n: lm_solve_batch(
        *case.args, fixed.replace(max_iterations=n), part))
    per_chain = iteration_launches(lambda n: lm_solve(
        prob.poses0, prob.switches0, alone_edges[0], prob.free,
        fixed.replace(max_iterations=n), partition=prob.partition))
    extra = cg_fields(cg, counts) if solver == "pcg" else {}
    log(phase, part="a", solver=solver, dtype="float64", chains=ch.chains,
        max_iterations=cfg.max_iterations, setup_s=round(setup, 3),
        lane_iterations=json.dumps(res.iterations.tolist()),
        accepted=json.dumps(res.accepted.tolist()),
        converged=json.dumps(res.converged.tolist()),
        lin_iters=json.dumps(res.lin_iters.tolist()),
        batch_wall_s=json.dumps([round(b1[1], 4), round(b2[1], 4)]),
        chains_alone_wall_s=json.dumps([round(c1[1], 4), round(c2[1], 4)]),
        rel_diff=json.dumps(rel), pose_diff_m=json.dumps(dp),
        same_counts=json.dumps(same), bitwise_equal=json.dumps(bitwise),
        gate_rel=RESCUE_F64_RTOL, gate_pose_m=RESCUE_F64_POSE_ATOL,
        launches=json.dumps(counts),
        launches_per_batched_iter=json.dumps(per_batch),
        launches_per_chain_iter=json.dumps(per_chain), **extra,
        card=json.dumps(smi))
    if not (all(same) and max(rel) <= RESCUE_F64_RTOL
            and max(dp) <= RESCUE_F64_POSE_ATOL):
        raise AssertionError(f"{phase}: lanes vs chains alone: counts equal "
                             f"{same}, rel {max(rel)}, poses {max(dp)} m")
    if per_batch != per_chain:
        raise AssertionError(f"{phase}: launches per batched iteration "
                             f"{per_batch}, per chain {per_chain}")
    if solver == "pcg":
        per_cg = json.loads(extra["launches_per_loop_cg_iter"])
        over = {k: v for k, v in per_cg.items()
                if k in ("gather_rows", "scatter_add_rows")
                and v > PCG_LAUNCH_LIMIT}
        if over:
            raise AssertionError(f"{phase}: launches per CG iteration of "
                                 f"the loop {over} above {PCG_LAUNCH_LIMIT}")
    require_launches(phase, counts)
    return counts


def seed_lanes(phase: str, solver: str, device, smi: str,
               timings: list) -> dict:
    """(b) of [pcg_batch] and [woodbury_batch]: float32, the seed batch of
    ``scripts/bench_pcg.py`` or ``scripts/bench_woodbury.py`` (INTEL+50 x
    seeds 0-7, ``BATCH_ITERS`` iterations): each seed's cost against
    ``bench.py``'s gate (raised on PCG; on Woodbury printed, its f32
    correction cancels), CG iterations per seed, wall, launches and peak
    allocated memory; LM it/s of the batch and of ``LANE_ALONE_SEEDS``
    seeds alone over ``LANE_TIMED_ITERS`` iterations, in turns; device ms
    and busy share a batched iteration appended to ``timings``.  Returns
    the batch's launch counts."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.solver.batch import lm_fixed_iters_batch
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.tools.problems import BATCH_ITERS, \
        intel50_seed_batch

    t0 = time.perf_counter()
    case = intel50_seed_batch(device, torch.float32, solver)
    b, plan, cfg = case.batch, case.plan, case.cfg
    B = b.seeds
    alone = case.alone[:LANE_ALONE_SEEDS]
    setup = time.perf_counter() - t0
    lm_fixed_iters_batch(*b.args, cfg, 1, partition=plan)  # warm-up
    for args, p in alone:
        lm_fixed_iters(*args, cfg, 1, partition=p)

    cg = []
    with cg_counts(cg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = lm_fixed_iters_batch(*b.args, cfg, BATCH_ITERS, partition=plan)
        costs = res.cost.tolist()  # synchronises
        wall = time.perf_counter() - t0
    counts, peak = ops.launch_counts(), torch.cuda.max_memory_allocated() \
        - held
    costs0 = res.initial_cost.tolist()
    ok = all(c0 > SEED_BATCH_COST0_MIN and c < SEED_BATCH_COST_FRAC * c0
             for c, c0 in zip(costs, costs0))

    n = LANE_TIMED_ITERS

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def run_batch():
        lm_fixed_iters_batch(*b.args, cfg, n, partition=plan)

    def run_alone():
        for args, p in alone:
            lm_fixed_iters(*args, cfg, n, partition=p)

    walls = [timed(f) for f in (run_batch, run_alone, run_alone, run_batch)]
    batch_wall, alone_wall = (walls[0] + walls[3]) / 2, (walls[1]
                                                         + walls[2]) / 2
    extra = {}
    if solver == "pcg":
        extra = cg_fields(cg, counts)
        extra.update(
            cg_iterations_per_seed=json.dumps(res.lin_iters.tolist()),
            ms_per_loop_cg_iter=wall * 1e3 / extra["loop_cg_iterations"])
    log(phase, part="b", solver=solver, dtype="float32", seeds=B,
        iters=BATCH_ITERS, setup_s=round(setup, 3),
        lowrank_per_seed=getattr(plan, "num_lowrank", None),
        costs=json.dumps(costs), initial_costs=json.dumps(costs0),
        accepted=json.dumps(res.accepted.tolist()),
        gate_bench=ok, gate_raised=solver == "pcg", wall_s=round(wall, 4),
        ms_per_batched_iter=wall * 1e3 / BATCH_ITERS,
        peak_bytes_batch=peak,
        launches_per_iter=json.dumps({k: v / BATCH_ITERS
                                      for k, v in counts.items()}),
        timed_iters=n, batch_walls_s=json.dumps([round(w, 4) for w in
                                                 (walls[0], walls[3])]),
        alone_walls_s=json.dumps([round(w, 4) for w in walls[1:3]]),
        lm_it_per_s=round(B * n / batch_wall, 3),
        alone_lm_it_per_s=round(len(alone) * n / alone_wall, 3), **extra,
        card=json.dumps(smi))
    if solver == "pcg" and not ok:
        raise AssertionError(f"{phase}: seeds miss bench_pcg.py's gate: "
                             f"{costs} from {costs0}")
    require_launches(f"{phase}_seeds", counts)
    # A profiler session over PCG's ~100 CG iterations an LM iteration
    # (~33 000 device events) takes minutes: PCG's device time is taken
    # over one LM iteration cut to PCG_PROFILE_CG CG iterations, against
    # the same run's unprofiled wall.
    pcfg, k = (cfg.replace(pcg_max_iters=PCG_PROFILE_CG), 1) \
        if solver == "pcg" else (cfg, SEED_BATCH_PROFILE_ITERS)

    def device_times():  # profiled in the report, after every other time
        def run(n):
            lm_fixed_iters_batch(*b.args, pcfg, n, partition=plan)

        run(k)
        wall_ms = timed(lambda: run(k)) * 1e3 / k
        extra = {"cg_iterations_per_iter": PCG_PROFILE_CG} \
            if solver == "pcg" else {}
        log(phase, part="b", solver=solver,
            **batch_device_ms(run, wall_ms, k), wall_ms_per_iter=wall_ms,
            **extra, card=json.dumps(smi))

    timings.append(lambda: ([], [], device_times))
    return counts


@functools.lru_cache(maxsize=1)
def schur_round_masks(device):
    """The rescue's first-round masks of INTEL+50 seed 42, built from the
    plain float64 solve on the Schur solver, as [rescue_batch] (a) has
    them."""
    from slam_tpu_torch.tools.problems import intel50_chains

    return intel50_chains(device, "float64").masks


def phase_pcg_batch(device, smi: str, timings: list) -> dict:
    """Phase 6g: the batched PCG.  (a) and (b) as :func:`chain_lanes` and
    :func:`seed_lanes`; (c) the managers' PCG eval folded: the float64
    fused runs' last batches of each width against each lane alone
    (:func:`fold_lanes_f64`, cut to ``PCG_FOLD_CANDIDATES`` closures),
    and M3500+50 method 4 on the host engine (its eval is PCG above 2048
    nodes) cut to ``HOST_PCG_CANDIDATES`` closures: wall, calls and
    solves per candidate.  Returns the launch counts of each path."""
    out = {"pcg_batch": chain_lanes("pcg_batch", "pcg",
                                    schur_round_masks(device), device, smi,
                                    PCG_ROUND_ITERS),
           "pcg_batch_seeds": seed_lanes("pcg_batch", "pcg", device, smi,
                                         timings)}
    for method in (3, 4):
        fold_lanes_f64("pcg", method, PCG_FOLD_CANDIDATES, smi)
    mgr = fused_manager("M3500", 50, 0, 4, fused="off")
    mgr.loop_indices = mgr.loop_indices[:HOST_PCG_CANDIDATES]
    _, wall, counts = run_manager(mgr)
    n = len(mgr.loop_indices)
    log("pcg_batch", part="c", cell="m3500_m4", engine="host",
        eval=mgr.eval_cfg.linear_solver, candidates=n, wall_s=round(wall, 3),
        s_per_candidate=wall / n, calls_per_candidate=mgr.ss.calls / n,
        short_solves_per_candidate=mgr.ss.solves / n,
        launches=json.dumps(counts), card=json.dumps(smi))
    if mgr.eval_cfg.linear_solver != "pcg" or not \
            mgr.ss.calls < mgr.ss.solves:
        raise AssertionError(f"pcg_batch: M3500 host eval "
                             f"{mgr.eval_cfg.linear_solver}, {mgr.ss.calls} "
                             f"calls for {mgr.ss.solves} solves")
    require_launches("pcg_eval_host", counts)
    out["pcg_eval_host"] = counts
    return out


def phase_woodbury_batch(device, smi: str, timings: list) -> dict:
    """Phase 6h: the batched Woodbury solver, (a) and (b) as
    :func:`chain_lanes` (to convergence) and :func:`seed_lanes`.  Returns
    the launch counts of each path."""
    return {"woodbury_batch": chain_lanes(
                "woodbury_batch", "woodbury", schur_round_masks(device),
                device, smi, None),
            "woodbury_batch_seeds": seed_lanes("woodbury_batch", "woodbury",
                                               device, smi, timings)}


def lanes_alone(c, cfg, iters: int) -> tuple:
    """The batch of ``c`` (a ``problems.BatchCase``) and each of its seeds
    alone, ``iters`` iterations each: (the batch's result, per seed its
    relative cost difference, largest pose and switch differences and
    whether its accepted steps and CG iterations are equal)."""
    from slam_tpu_torch.solver.batch import lm_fixed_iters_batch
    from slam_tpu_torch.solver.lm import lm_fixed_iters

    res = lm_fixed_iters_batch(*c.batch.args, cfg, iters, partition=c.plan)
    rel, dp, ds, acc = [], [], [], []
    for i, (args, p) in enumerate(c.alone):
        r = lm_fixed_iters(*args, cfg, iters, partition=p)
        rel.append(abs(float(res.cost[i]) - float(r.cost))
                   / abs(float(r.cost)))
        dp.append(float((res.poses[i] - r.poses).abs().max()))
        ds.append(float((res.switches[i] - r.switches).abs().max()))
        acc.append([int(res.accepted[i]), int(res.lin_iters[i])]
                   == [int(r.accepted), int(r.lin_iters)])
    return res, rel, dp, ds, acc


def phase_sc_batch(device, smi: str, timings: list) -> dict:
    """Phase 6i: joint switchable constraints (method 2) in the seed
    batch, on each configuration of ``problems.SC_BATCH_CONFIGS``.  (a)
    float64: each seed of the batch against its run alone (cost, poses,
    switches, accepted steps and CG iterations) over
    ``SC_BATCH_F64_ITERS`` iterations; (b) float32: the same after one
    iteration (``SC_BATCH_STEP_TOL``), and the launches of a
    batched iteration against one seed's (B5 on the blocked-kernel run,
    B3 on none); (c) float32: each seed's cost after the batch's
    iterations against ``bench.py``'s gate and its float64 batch cost
    (PCG: its launches per iteration of the CG loop too), and the batch's
    wall, LM it/s and peak allocated memory against the
    seeds alone, in turns (batch, seeds, seeds, batch); the device ms and
    busy share of a batched iteration (Schur native, dense) appended to
    ``timings``.  Returns each configuration's float32 batch launch
    counts."""
    from slam_tpu_torch.solver.batch import lm_fixed_iters_batch
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.tools.problems import BATCH_ITERS, \
        SC_BATCH_CONFIGS, SC_PCG_ITERS

    t0 = time.perf_counter()
    dtypes = (torch.float32, torch.float64)
    cases = {(solver, dt): sc_case(device, solver, dt)
             for solver, _ in SC_BATCH_CONFIGS.values() for dt in dtypes}
    b = cases["schur", torch.float32].batch
    B = b.seeds
    log("sc_batch", seeds=B, nodes=b.poses0.shape[1],
        edges_per_seed=b.switches0.shape[1],
        pad_shapes=json.dumps(list(b.pad_shapes)),
        dense_unknowns_per_seed=3 * b.poses0.shape[1] + b.switches0.shape[1],
        setup_s=round(time.perf_counter() - t0, 3))

    def setup(name, dtype):
        solver, kw = SC_BATCH_CONFIGS[name]
        c = cases[solver, dtype]
        return c, c.cfg.replace(**kw)

    def iters_of(name):
        return SC_PCG_ITERS if name == "pcg" else BATCH_ITERS

    # (a) float64: each seed against its run alone; the float64 batch
    # cost, the float32 gate's reference.
    ref64 = {}
    for name, n in SC_BATCH_F64_ITERS.items():
        t1 = time.perf_counter()
        c, cfg = setup(name, torch.float64)
        res, rel, dp, ds, acc = lanes_alone(c, cfg, n)
        ref64[name] = SC_BATCH_PCG_F64 if name == "pcg" else \
            res.cost.tolist()  # after BATCH_ITERS, as the float32 run
        log("sc_batch", part="a", config=name, dtype="float64", iters=n,
            rel_diff=json.dumps(rel), pose_diff_m=json.dumps(dp),
            switch_diff=json.dumps(ds), counts_equal=json.dumps(acc),
            accepted=json.dumps(res.accepted.tolist()),
            cg_iterations=json.dumps(res.lin_iters.tolist()),
            costs=json.dumps(res.cost.tolist()),
            f64_costs_at_f32_iters=json.dumps(ref64[name]),
            gate_rel=SEED_BATCH_F64_RTOL, gate_m=SEED_BATCH_F64_POSE_ATOL,
            s=round(time.perf_counter() - t1, 3))
        if not (all(acc) and max(rel) <= SEED_BATCH_F64_RTOL
                and max(dp + ds) <= SEED_BATCH_F64_POSE_ATOL):
            raise AssertionError(f"sc_batch {name} float64: batch vs alone "
                                 f"rel {max(rel)}, poses {max(dp)}, "
                                 f"switches {max(ds)}, counts equal {acc}")
    ref64["blocked_micro"] = ref64["native"]  # as f32_spread measures it

    # (b) float32: one iteration against the seeds alone; the launches of
    # a batched iteration against one seed's (PCG: every CG run to
    # PCG_FIXED_CG iterations).
    for name in SC_BATCH_CONFIGS:
        t1 = time.perf_counter()
        c, cfg = setup(name, torch.float32)
        rtol, atol = SC_BATCH_STEP_TOL.get(
            name, (SEED_BATCH_STEP_RTOL, SEED_BATCH_STEP_POSE_ATOL))
        res, rel, dp, ds, acc = lanes_alone(c, cfg, 1)
        fixed = cfg.replace(pcg_rtol=0.0, pcg_max_iters=PCG_FIXED_CG) \
            if name == "pcg" else cfg
        (args, p) = c.alone[0]
        per_batch = iteration_launches(lambda k: lm_fixed_iters_batch(
            *c.batch.args, fixed, k, partition=c.plan))
        per_seed = iteration_launches(lambda k: lm_fixed_iters(
            *args, fixed, k, partition=p))
        log("sc_batch", part="b", config=name, dtype="float32", iters=1,
            rel_diff=json.dumps(rel), pose_diff_m=json.dumps(dp),
            switch_diff=json.dumps(ds), counts_equal=json.dumps(acc),
            gate_rel=rtol, gate_m=atol,
            launches_per_batched_iter=json.dumps(per_batch),
            launches_per_seed_iter=json.dumps(per_seed),
            s=round(time.perf_counter() - t1, 3))
        if not (all(acc) and max(rel) <= rtol and max(dp + ds) <= atol):
            raise AssertionError(f"sc_batch {name} float32 step: rel "
                                 f"{max(rel)}, poses {max(dp)}, switches "
                                 f"{max(ds)}, counts equal {acc}")
        if per_batch != per_seed or per_batch["fused_linearize_se2"] or (
                name == "blocked_micro") != (per_batch["micro_chol_inv"]
                                             > 0):
            raise AssertionError(f"sc_batch {name}: launches per batched "
                                 f"iteration {per_batch}, per seed "
                                 f"{per_seed}")

    # (c) float32: the gates, and the batch against the seeds alone.
    out, walls_ms = {}, {}
    for name in SC_BATCH_CONFIGS:
        t1 = time.perf_counter()
        c, cfg = setup(name, torch.float32)
        pcg = name == "pcg"
        timed = c._replace(alone=c.alone[:LANE_ALONE_SEEDS]) if pcg else c
        n = SC_PCG_TIMED_ITERS if pcg else SC_BATCH_TIMED_ITERS
        lm_fixed_iters_batch(*c.batch.args, cfg, 1, partition=c.plan)
        for args, p in timed.alone:  # warm-up
            lm_fixed_iters(*args, cfg, 1, partition=p)
        cg = []
        with cg_counts(cg):
            res, wall, counts, costs, peak = timed_batch(c, cfg,
                                                         iters_of(name))
        runs = [timed_batch(timed, cfg, n), timed_alone(timed, cfg, n),
                timed_alone(timed, cfg, n), timed_batch(timed, cfg, n)]
        batch_wall = (runs[0][1] + runs[3][1]) / 2
        alone_wall = (runs[1][1] + runs[2][1]) / 2
        walls_ms[name] = batch_wall * 1e3 / n
        costs0 = res.initial_cost.tolist()
        rel64 = [abs(x - r) / abs(r) for x, r in zip(costs, ref64[name])]
        extra = dict(cg_fields(cg, counts), cg_iterations_per_seed=json.dumps(
            res.lin_iters.tolist())) if pcg else {}
        log("sc_batch", part="c", config=name, dtype="float32",
            iters=iters_of(name), costs=json.dumps(costs),
            initial_costs=json.dumps(costs0),
            accepted=json.dumps(res.accepted.tolist()),
            f64_costs=json.dumps(ref64[name]), rel_to_f64=json.dumps(rel64),
            gate_rel_to_f64=SC_BATCH_F32_RTOL[name], wall_s=round(wall, 4),
            ms_per_batched_iter=wall * 1e3 / iters_of(name),
            peak_bytes_batch=peak, timed_iters=n,
            timed_seeds_alone=len(timed.alone),
            batch_walls_s=json.dumps([round(runs[0][1], 4),
                                      round(runs[3][1], 4)]),
            alone_walls_s=json.dumps([round(runs[1][1], 4),
                                      round(runs[2][1], 4)]),
            lm_it_per_s=round(B * n / batch_wall, 2),
            alone_lm_it_per_s=round(len(timed.alone) * n / alone_wall, 2),
            timed_peak_bytes_batch=runs[0][4],
            timed_peak_bytes_alone=runs[1][4],
            launches_per_iter=json.dumps({k: v / iters_of(name)
                                          for k, v in counts.items()}),
            **extra, s=round(time.perf_counter() - t1, 3),
            card=json.dumps(smi))
        bad = [i for i, (x, x0) in enumerate(zip(costs, costs0))
               if not (x0 > SEED_BATCH_COST0_MIN
                       and x < SEED_BATCH_COST_FRAC * x0)]
        if bad:
            raise AssertionError(f"sc_batch {name}: seeds {bad} miss "
                                 "bench.py's gate")
        if max(rel64) > SC_BATCH_F32_RTOL[name]:
            raise AssertionError(
                f"sc_batch {name}: float32 cost {max(rel64)} from the "
                f"float64 batch's, above {SC_BATCH_F32_RTOL[name]}")
        if counts["fused_linearize_se2"]:
            raise AssertionError(f"sc_batch {name}: fused_linearize_se2 "
                                 "launched under joint SC")
        over = {k: v for k, v in json.loads(extra.get(
            "launches_per_loop_cg_iter", "{}")).items()
            if k in ("gather_rows", "scatter_add_rows")
            and v > PCG_LAUNCH_LIMIT}
        if over:
            raise AssertionError(f"sc_batch pcg: launches per iteration of "
                                 f"the CG loop {over} above "
                                 f"{PCG_LAUNCH_LIMIT}")
        require_launches(f"sc_batch_{name}", counts)
        out[f"sc_batch_{name}"] = counts

    def device_times():  # profiled in the report, after every other time
        for name in ("native", "dense"):
            c, cfg = setup(name, torch.float32)
            log("sc_batch", config=name, **batch_device_ms(
                lambda k, c=c, cfg=cfg: lm_fixed_iters_batch(
                    *c.batch.args, cfg, k, partition=c.plan),
                walls_ms[name]), wall_ms_per_iter=walls_ms[name],
                card=json.dumps(smi))

    timings.append(lambda: ([], [], device_times))
    return out


def reference(key: str) -> dict:
    with open(os.path.join(REPO, "slam_tpu_torch", "data",
                           "reference_costs.json")) as f:
        return json.load(f)[key]


def held_to(phase: str, cost: float, key: str, gate: float) -> float:
    """The relative difference of ``cost`` from the float64 reference
    ``key``; raises above ``gate``."""
    ref = reference(key)["final_cost"]
    rel = abs(cost - ref) / abs(ref)
    if not (np.isfinite(cost) and rel <= gate):
        raise AssertionError(f"{phase}: cost {cost} vs float64 reference "
                             f"{ref} ({key}): rel {rel} > {gate}")
    return rel


def log_record(path: str, tag: str) -> dict:
    """The ``key=value`` fields of the last ``[tag]`` line of a run log."""
    fields = {}
    with open(path) as f:
        for line in f:
            if line.startswith(f"[{tag}] "):
                fields = dict(w.split("=", 1) for w in line.split()[1:]
                              if "=" in w)
    if not fields:
        raise AssertionError(f"no [{tag}] line in {path}")
    return fields


def check_switches(phase: str, path: str, ref: dict) -> int:
    """``switches.txt`` in the reference's layout (``g2o_util.h:114-148``):
    the odometry section (rows ``a b 0 1 1``), then the closure and the
    bogus section (rows ``a b type prior switch``), as many loop rows as
    the reference run has.  Returns the count of loop switches < 0.5."""
    with open(path) as f:
        lines = f.read().splitlines()
    heads = ["Odometry EDGES AHEAD", "Closure EDGES AHEAD",
             "BOGUS EDGES AHEAD"]
    if [ln for ln in lines if not ln[:1].isdigit()] != heads \
            or lines[0] != heads[0]:
        raise AssertionError(f"{phase}: switches.txt sections differ")
    section, loops = -1, []
    for ln in lines:
        if ln in heads:
            section = heads.index(ln)
            continue
        w = ln.split()
        if len(w) != 5 or int(w[2]) != section:
            raise AssertionError(f"{phase}: switches.txt row {ln!r}")
        if section == 0:
            if w[3:] != ["1", "1"]:
                raise AssertionError(f"{phase}: odometry row {ln!r}")
        else:
            loops.append(float(w[4]))
    if len(loops) != ref["loop_edges"] or not np.isfinite(loops).all():
        raise AssertionError(f"{phase}: {len(loops)} loop switches, "
                             f"reference {ref['loop_edges']}")
    return int(sum(v < 0.5 for v in loops))


def run_method2_cli(phase: str, argv: list) -> tuple[dict, dict]:
    """``cli.main(argv)`` through :func:`run_cli_path`; returns the launch
    counts and what the run left: its ``[solve]`` and ``[report]``
    records, its count of loop switches < 0.5, its reference, its wall
    seconds."""
    from slam_tpu_torch import cli

    got = {}

    def run(save):
        if cli.main([*argv, "--save-path", save]) != 0:
            raise AssertionError(f"{phase}: cli.main failed")
        logf = os.path.join(save, "method2.log")
        got["solve"] = log_record(logf, "solve")
        got["report"] = log_record(logf, "report")
        got["switches"] = os.path.join(save, "switches.txt")
        if not os.path.isfile(got["switches"]):
            raise AssertionError(f"{phase} wrote no switches.txt")
        got["below_half"] = check_switches(phase, got["switches"],
                                           got["ref"])

    robust = "sc_varpro" if "--sc-varpro" in argv else "sc"
    got["ref"] = reference(f"intel50_{robust}_cli")
    counts, wall, poses = run_cli_path(phase, run)
    if poses.shape[0] != 1228 or not np.isfinite(poses).all():
        raise AssertionError(f"{phase}: opt_nodes {poses.shape} or "
                             "non-finite")
    got["wall"] = wall
    return counts, got


def phase_method2_path(smi: str) -> dict:
    """Phase 7a: the method-2 CLI, joint SC and ``--sc-varpro``."""
    out = {}
    for phase, robust, flag in (("method2_path", "sc", []),
                                ("method2_varpro", "sc_varpro",
                                 ["--sc-varpro"])):
        counts, got = run_method2_cli(
            phase, ["INTEL", "50", "2", "--seed", "42", *flag])
        solve, ref = got["solve"], got["ref"]
        cost, iters = float(solve["final_cost"]), int(solve["iterations"])
        gate = M2_REF_COST_RTOL[(robust, "schur", True)]
        rel = held_to(phase, cost, f"intel50_{robust}_cli", gate)
        log(phase, wall_s=round(got["wall"], 3), final_cost=cost,
            reference_f64=ref["final_cost"], rel_diff=rel, gate=gate,
            iterations=iters, accepted=int(solve["accepted"]),
            reference_accepted=ref["accepted"],
            loop_switches_below_half=got["below_half"],
            reference_below_half=ref["loop_switches_below_half"],
            launches=json.dumps(counts),
            launches_per_iter=json.dumps({k: n / iters
                                          for k, n in counts.items()}),
            card=json.dumps(smi))
        if got["below_half"] != ref["loop_switches_below_half"]:
            raise AssertionError(f"{phase}: {got['below_half']} loop "
                                 "switches < 0.5, reference "
                                 f"{ref['loop_switches_below_half']}")
        require_launches(phase, counts)
        out[phase] = counts
    return out


def phase_method2_dense(device, smi: str) -> dict:
    """Phase 7b: joint SC on the dense joint system."""
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.tools.problems import intel50_plain

    key = "intel50_sc_dense_lm_fixed_iters"
    iters = reference(key)["iterations"]
    prob = intel50_plain(device, "float32", "sc", "dense")
    args = (prob.poses0, prob.switches0, prob.edges, prob.free)
    lm_fixed_iters(*args, prob.scfg, 2, partition=prob.partition)
    res, wall, counts, cost = timed_lm(args, prob.scfg, iters,
                                       prob.partition)
    gate = M2_REF_COST_RTOL[("sc", "dense", False)]
    rel = held_to("method2_dense", cost, key, gate)
    n, E = prob.poses0.shape[0], prob.edges.num_edges
    log("method2_dense", unknowns=3 * n + E, final_cost=cost,
        initial_cost=float(res.initial_cost),
        reference_f64=reference(key)["final_cost"], rel_diff=rel, gate=gate,
        accepted=int(res.accepted), iters=iters, wall_s=round(wall, 4),
        lm_it_per_s=round(iters / wall, 2),
        launches_per_iter=json.dumps({k: n_ / iters
                                      for k, n_ in counts.items()}),
        card=json.dumps(smi))
    require_launches("method2_dense", counts)
    return counts


def phase_method2_ab(device, smi: str) -> dict:
    """Phase 7c: joint SC under the three Schur factorisations."""
    from slam_tpu_torch.tools.problems import intel50_plain, m10000

    key = "intel50_sc_schur_lm_fixed_iters"
    iters = reference(key)["iterations"]
    prob = intel50_plain(device, "float32", "sc", "schur")
    m = m10000(device, torch.float32, "sc")
    cases = {
        "INTEL": ((prob.poses0, prob.switches0, prob.edges, prob.free),
                  prob.scfg, prob.partition),
        "M10000": (m.args, m.cfg, m.partition),
    }
    gate = M2_REF_COST_RTOL[("sc", "schur", False)]
    counts = None
    for label, (args, base, part) in cases.items():
        runs = lm_in_turns("method2_ab", label, args, base, part, iters,
                           smi)
        for name, rs in runs.items():
            res, _, _, cost = rs[0]
            if label == "INTEL":
                rel = held_to(f"method2_ab {name}", cost, key, gate)
                log("method2_ab", shape=label, config=name,
                    reference_f64=reference(key)["final_cost"],
                    rel_diff=rel, gate=gate)
            else:
                cost0 = float(res.initial_cost)
                if not (np.isfinite(cost)
                        and cost <= SCALE_COST_FRAC * cost0):
                    raise AssertionError(
                        f"method2_ab M10000 {name}: cost {cost} > "
                        f"{SCALE_COST_FRAC} x {cost0}")
        micro = runs["blocked_micro"][0][2]
        require_launches("method2_ab", micro)
        if label == "INTEL":
            counts = micro
            over = {k: n / iters for k, n in runs["native"][0][2].items()
                    if n / iters > M2_LAUNCH_LIMITS.get(k, float("inf"))}
            if over:
                raise AssertionError(f"INTEL joint SC native launches per "
                                     f"iteration {over} above "
                                     f"{M2_LAUNCH_LIMITS}")
    return counts


def phase_pcg(device, smi: str) -> dict:
    """Phase 7d: plain DCS and joint SC on PCG."""
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.tools.problems import intel50_plain, reference_key

    out = {}
    for phase, robust in (("pcg_dcs", "dcs"), ("pcg_sc", "sc")):
        key = reference_key(robust, "pcg")
        ref = reference(key)
        iters = ref["iterations"]
        prob = intel50_plain(device, "float32", robust, "pcg")
        args = (prob.poses0, prob.switches0, prob.edges, prob.free)
        lm_fixed_iters(*args, prob.scfg, 1, partition=None)  # warm-up
        res, wall, counts, cost = timed_lm(args, prob.scfg, iters, None)
        cg = int(res.lin_iters)
        gate = M2_REF_COST_RTOL[(robust, "pcg", False)]
        rel = held_to(phase, cost, key, gate)
        per_cg = {k: n / cg for k, n in counts.items()}
        log("pcg", robust=robust, final_cost=cost,
            initial_cost=float(res.initial_cost),
            reference_f64=ref["final_cost"], rel_diff=rel, gate=gate,
            accepted=int(res.accepted), reference_accepted=ref["accepted"],
            iters=iters, cg_iterations=cg,
            reference_cg_iterations=ref["cg_iterations"],
            wall_s=round(wall, 4), ms_per_cg_iter=round(wall * 1e3 / cg, 4),
            lm_it_per_s=round(iters / wall, 3),
            launches_per_cg_iter=json.dumps(per_cg), card=json.dumps(smi))
        require_launches(phase, counts)
        over = {k: v for k, v in per_cg.items()
                if k in ("gather_rows", "scatter_add_rows")
                and v > PCG_LAUNCH_LIMIT}
        if over:
            raise AssertionError(f"{phase}: launches per CG iteration "
                                 f"{over} above {PCG_LAUNCH_LIMIT}")
        out[phase] = counts
    return out


def phase_report_stages(smi: str) -> dict:
    """Phase 7e: the method-2 CLI with ``--report-stages``."""
    counts, got = run_method2_cli(
        "report_stages",
        ["INTEL", "50", "2", "--seed", "42", "--report-stages"])
    stages = {k: float(got["report"].get(f"t_{k}_s", "nan"))
              for k in ("linearize", "linear_solve", "retract_cost")}
    log("report_stages", **{f"{k}_ms": v * 1e3 for k, v in stages.items()},
        launches=json.dumps(counts), card=json.dumps(smi))
    bad = {k: v for k, v in stages.items() if not (np.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"report_stages: stage times {bad}")
    require_launches("report_stages", counts)
    return counts


def phase_se3_path(smi: str) -> dict:
    """Phase 8a: ``sphere2500 50 1 --seed 0`` through the CLI."""
    from slam_tpu_torch import cli
    from slam_tpu_torch.eval import metrics

    got = {}

    def run(save):
        if cli.main(["sphere2500", "50", "1", "--seed", "0", "--save-path",
                     save]) != 0:
            raise AssertionError("se3_path: cli.main failed")
        got["solve"] = log_record(os.path.join(save, "method1.log"),
                                  "solve")

    counts, wall, poses = run_cli_path("se3_path", run)
    golden = np.load(os.path.join(REPO, "results", "golden",
                                  "sphere2500_50out_seed0.npy"))
    if poses.shape != golden.shape or not np.isfinite(poses).all():
        raise AssertionError(f"se3_path: opt_nodes {poses.shape} or "
                             "non-finite")
    ate = metrics.ate(poses, golden)
    solve, ref = got["solve"], reference("sphere2500_50_1_cli")
    iters = int(solve["iterations"])
    log("se3_path", wall_s=round(wall, 3), ate_vs_golden_m=ate,
        gate_m=SE3_ATE_GATE_M, reference_f64_ate_m=ref["ate_vs_golden_m"],
        final_cost=float(solve["final_cost"]),
        reference_f64=ref["final_cost"], iterations=iters,
        accepted=int(solve["accepted"]), launches=json.dumps(counts),
        card=json.dumps(smi))
    if not ate < SE3_ATE_GATE_M:
        raise AssertionError(f"se3_path: ATE {ate} m >= {SE3_ATE_GATE_M} m")
    require_launches("se3_path", counts)
    return counts


def phase_se3_ab(device, smi: str) -> dict:
    """Phase 8b: the sphere2500 recipe under the three factorisations."""
    from slam_tpu_torch.tools.problems import SPHERE_ITERS, sphere2500, \
        sphere_reference_key

    case = sphere2500(device, torch.float32)
    runs = lm_in_turns("se3_ab", "sphere2500", case.args, case.cfg,
                       case.partition, SPHERE_ITERS, smi)
    for name, rs in runs.items():
        cost = rs[0][3]
        key = sphere_reference_key(name)
        rel = held_to(f"se3_ab {name}", cost, key, SE3_REF_COST_RTOL)
        cost0 = float(rs[0][0].initial_cost)
        log("se3_ab", shape="sphere2500", config=name,
            reference_f64=reference(key)["final_cost"], rel_diff=rel,
            gate=SE3_REF_COST_RTOL, cost_frac=cost / cost0,
            gate_frac=SCALE_COST_FRAC)
        if not cost <= SCALE_COST_FRAC * cost0:
            raise AssertionError(f"se3_ab {name}: cost {cost} > "
                                 f"{SCALE_COST_FRAC} x {cost0}")
    micro = runs["blocked_micro"][0][2]
    require_launches("se3_ab", micro)
    return micro


def phase_golden(device, smi: str) -> dict:
    """Phase 8c: the dense-solver golden cells."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.config import SolverConfig
    from slam_tpu_torch.eval import metrics
    from slam_tpu_torch.io import g2o
    from slam_tpu_torch.solver.lm import lm_solve
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph

    with open(os.path.join(REPO, "results", "golden", "meta.json")) as f:
        meta = json.load(f)
    total = {}
    for key, (name, outliers, seed, robust, max_ate, factor, offset) \
            in GOLDEN_CELLS.items():
        g = g2o.load_g2o(g2o.find_dataset(name))
        g = g.add_random_outliers(outliers, seed=seed)
        edges = edge_set_from_graph(g, dtype=torch.float32, device=device)
        cfg = SolverConfig(robust=robust, linear_solver="dense",
                           dtype="float32", max_iterations=40)
        args = (torch.as_tensor(g.poses, dtype=torch.float32,
                                device=device),
                torch.ones((edges.num_edges,), dtype=torch.float32,
                           device=device),
                edges, anchor_first_node(g.num_nodes, dtype=torch.float32,
                                         device=device))
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = lm_solve(*args, cfg)
        poses = res.poses.cpu().numpy()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        ate = metrics.ate(poses, np.load(os.path.join(
            REPO, "results", "golden", f"{key}.npy")))
        cost = float(res.cost)
        cost_gate = factor * meta[key]["final_cost"] + offset
        log("golden", cell=key, ate_m=ate, gate_m=max_ate, final_cost=cost,
            cost_gate=cost_gate, iterations=int(res.iterations),
            accepted=int(res.accepted), wall_s=round(wall, 3),
            launches=json.dumps(counts), card=json.dumps(smi))
        if not (np.isfinite(poses).all() and ate < max_ate):
            raise AssertionError(f"golden {key}: ATE {ate} m >= {max_ate}")
        if not cost < cost_gate:
            raise AssertionError(f"golden {key}: cost {cost} >= "
                                 f"{cost_gate}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    require_launches("golden", total)
    return total


def check_manager_cell(phase: str, row: dict,
                       gates: dict = MANAGER_DIFF_GATES) -> None:
    """Phase 9's gates on one cell's diff against the oracle (and phase
    10a's, under ``gates``)."""
    cell, method = row["cell"], row["method"]
    n = row["candidates"]
    if row["count_mismatch"] or row["edges"] != n:
        raise AssertionError(f"{phase} {cell}: {row['edges']} decisions, "
                             f"the oracle's {n}")
    if cell == "intel50_m3":
        if row["identical_prefix"] < M3_NIELSEN_PREFIX:
            raise AssertionError(
                f"{phase} {cell}: identical prefix {row['identical_prefix']}"
                f" < {M3_NIELSEN_PREFIX}; first divergence "
                f"{json.dumps(row['first_divergence'])}")
    else:
        if row["identical_prefix"] != n or row["divergences"]:
            raise AssertionError(
                f"{phase} {cell}: {row['identical_prefix']}/{n} decisions "
                "equal the oracle's; first divergence "
                f"{json.dumps(row['first_divergence'])}")
        if row["best_layer"] != row["oracle_best_layer"]:
            raise AssertionError(f"{phase} {cell}: best layer "
                                 f"{row['best_layer']}, the oracle's "
                                 f"{row['oracle_best_layer']}")
        if method == 3 and not row["assignments_equal"]:
            raise AssertionError(f"{phase} {cell}: assignments differ")
    key = {"delta": "max_delta_diff_pre_divergence",
           "split_value": "max_split_value_diff_pre_divergence",
           "residual": "max_residual_diff_pre_divergence"}
    for what, gate in gates[cell].items():
        got = row[key[what]]
        if not (np.isfinite(got) and got <= gate):
            raise AssertionError(f"{phase} {cell}: largest {what} "
                                 f"difference {got} > {gate}")


def phase_managers(smi: str) -> dict:
    """Phase 9: methods 3 and 4 through the CLI against the oracle."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.tools.manager_spread import run_cell

    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    out = {}
    for phase, cells in MANAGER_PHASES.items():
        total = {}
        for cell in cells:
            torch.cuda.synchronize()
            ops.reset_launches()
            row = run_cell(cell, "cuda", stdout_path=os.path.join(
                REPO, "chiprun_out", f"{cell}.stdout.txt"), fused="off")
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            first = row.pop("first_divergence")
            log(phase, **{k: (json.dumps(v) if isinstance(v, (list, dict))
                              else v) for k, v in row.items()},
                launches=json.dumps(counts),
                launches_per_lm_iteration=json.dumps(
                    {k: n / row["lm_iterations"] for k, n in counts.items()}),
                card=json.dumps(smi))
            if first is not None:
                log(phase, cell=cell, first_divergence=json.dumps(first))
            row["first_divergence"] = first
            check_manager_cell(phase, row)
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
        require_launches(phase, total)
        out[phase] = total
    return out


@contextlib.contextmanager
def chunks_under_sync_mode(mode: str):
    """Run every chunk of the fused engines under
    ``torch.cuda.set_sync_debug_mode(mode)``: "error" raises at a host
    read inside a chunk, "warn" warns (and :func:`count_syncs` counts)."""
    from slam_tpu_torch.methods import layering_fused, mcts_fused

    saved = {mod: mod._fused_chunk for mod in (layering_fused, mcts_fused)}

    def under_mode(fn):
        def chunk(*args, **kw):
            torch.cuda.set_sync_debug_mode(mode)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return chunk

    for mod, fn in saved.items():
        mod._fused_chunk = under_mode(fn)
    try:
        yield
    finally:
        for mod, fn in saved.items():
            mod._fused_chunk = fn


@contextlib.contextmanager
def count_syncs(out: list):
    """Append to ``out`` the message of every synchronizing CUDA operation
    that the sync debug mode "warn" reports inside the block."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        yield
    out += [str(w.message) for w in seen
            if "synchronizing CUDA operation" in str(w.message)]


def fused_manager(dataset: str, outliers: int, seed: int, method: int,
                  flags: tuple = (), fused: str = "on"):
    """The engine of ``python -m slam_tpu_torch.cli DATASET OUTLIERS
    METHOD --seed SEED FLAGS --fused FUSED`` on the card, set up on the
    run's graph."""
    from slam_tpu_torch import cli
    from slam_tpu_torch.methods import layering, mcts
    from slam_tpu_torch.tools.manager_streams import cell_graph
    from slam_tpu_torch.utils.logging import RunLogger

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        [dataset, str(outliers), str(method), *flags]))
    engine = layering if method == 3 else mcts
    return engine.make_manager(cell_graph(dataset, outliers, seed), cfg,
                               RunLogger(echo=False), "cuda", fused=fused)


def run_manager(mgr) -> tuple:
    """``(output, wall seconds, launch counts)`` of a manager's run, the
    counts set to 0 just before it."""
    from slam_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = mgr.run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ops.launch_counts()


def phase_fused_managers(smi: str) -> dict:
    """Phase 10a: the fused engines through the CLI against the oracle,
    every chunk under the sync debug mode "error"; then the PCG eval's
    host reads."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.tools.manager_spread import run_cell

    phase = "fused_managers"
    total = {}
    with chunks_under_sync_mode("error"):
        for cell in FUSED_CELLS:
            torch.cuda.synchronize()
            ops.reset_launches()
            row = run_cell(cell, "cuda", stdout_path=os.path.join(
                REPO, "chiprun_out", f"{cell}.fused.stdout.txt"), fused="on")
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            if not row["fused"] or row["linear_solver"] != "schur":
                raise AssertionError(f"{phase} {cell}: fused={row['fused']}"
                                     f" eval {row['linear_solver']}")
            first = row.pop("first_divergence")
            n = row["candidates"]
            log(phase, **{k: (json.dumps(v) if isinstance(v, (list, dict))
                              else v) for k, v in row.items()},
                host_reads_per_candidate=0,
                launches=json.dumps(counts),
                launches_per_candidate=json.dumps(
                    {k: c / n for k, c in counts.items()}),
                card=json.dumps(smi))
            if first is not None:
                log(phase, cell=cell, first_divergence=json.dumps(first))
            row["first_divergence"] = first
            check_manager_cell(phase, row, FUSED_MANAGER_DIFF_GATES)
            for k, c in counts.items():
                total[k] = total.get(k, 0) + c
    require_launches(phase, total)

    # The PCG eval reads its CG stopping test on the host: the stated
    # exception, counted (not refused) under the mode "warn"; folded, it
    # must read less than while each evaluation was its own call.
    mgr = fused_manager("INTEL", 50, 42, 4, ("--eval-linear", "pcg"))
    mgr.loop_indices = mgr.loop_indices[:FUSED_PCG_CANDIDATES]
    syncs = []
    with chunks_under_sync_mode("warn"), count_syncs(syncs):
        _, wall, counts = run_manager(mgr)
    reads = len(syncs) / FUSED_PCG_CANDIDATES
    log("fused_pcg", cell="intel50_m4", candidates=FUSED_PCG_CANDIDATES,
        wall_s=round(wall, 3), s_per_candidate=wall / FUSED_PCG_CANDIDATES,
        short_solves=mgr.ss.solves, calls=mgr.ss.calls,
        calls_per_candidate=mgr.ss.calls / FUSED_PCG_CANDIDATES,
        lm_iterations=mgr.ss.iterations, host_reads_per_candidate=reads,
        looped_host_reads_per_candidate=FUSED_PCG_LOOPED_READS,
        launches=json.dumps(counts), card=json.dumps(smi))
    if mgr.eval_cfg.linear_solver != "pcg" or not syncs \
            or not reads < FUSED_PCG_LOOPED_READS:
        raise AssertionError(f"fused_pcg: {mgr.eval_cfg.linear_solver} "
                             f"eval, {reads} host reads a candidate")
    return total


def phase_fused_vs_host(smi: str) -> dict:
    """Phase 10b: method 4 on CSAIL+50 in float64, fused against host on
    the dense eval (the JAX package's fused-against-host test)."""
    flags = ("--dtype", "float64", "--eval-linear", "dense")
    runs = {}
    with chunks_under_sync_mode("error"):
        for fused in ("on", "off"):
            mgr = fused_manager("CSAIL", 50, 0, 4, flags, fused)
            out, wall, counts = run_manager(mgr)
            runs[fused] = (out, counts)
            log("fused_vs_host", engine="fused" if fused == "on" else "host",
                eval=mgr.eval_cfg.linear_solver, dtype=mgr.eval_cfg.dtype,
                wall_s=round(wall, 3), short_solves=mgr.ss.solves,
                calls=mgr.ss.calls, layers=len(out.layers),
                best=out.best_layer,
                launches=json.dumps(counts), card=json.dumps(smi))
    fo, ho = runs["on"][0], runs["off"][0]
    if fo.assignments != ho.assignments or list(fo.layers) != list(ho.layers) \
            or (fo.best_layer, fo.most_visited_layer, fo.most_edges_layer) \
            != (ho.best_layer, ho.most_visited_layer, ho.most_edges_layer):
        raise AssertionError("fused_vs_host: the decisions differ")
    worst = float(np.abs(fo.poses - ho.poses).max())
    for lid, hl in ho.layers.items():
        fl = fo.layers[lid]
        if (fl.parent, fl.visits) != (hl.parent, hl.visits) \
                or not (np.array_equal(fl.inherited, hl.inherited)
                        and np.array_equal(fl.added, hl.added)):
            raise AssertionError(f"fused_vs_host: layer {lid} differs")
        worst = max(worst, (fl.poses - hl.poses).abs().max().item(),
                    abs(fl.total_reward - hl.total_reward))
    log("fused_vs_host", assignments=len(fo.assignments),
        layers=len(fo.layers), identical=True, max_abs_diff=worst,
        atol=FUSED_VS_HOST_ATOL)
    if not worst <= FUSED_VS_HOST_ATOL:
        raise AssertionError(f"fused_vs_host: poses or rewards {worst} "
                             f"apart > {FUSED_VS_HOST_ATOL}")
    return runs["on"][1]


def phase_fused_m3500(smi: str) -> dict:
    """Phase 10c: M3500+50 method 4 on the fused engine, whole."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.tools.manager_spread import run_cell

    with open(os.path.join(REPO, "results", "layer_tables",
                           "M3500_50out_s0_m4.json")) as f:
        jax = json.load(f)
    with chunks_under_sync_mode("error"):
        torch.cuda.synchronize()
        ops.reset_launches()
        row = run_cell("m3500_m4", "cuda", stdout_path=os.path.join(
            REPO, "chiprun_out", "m3500_m4.fused.stdout.txt"), fused="on")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    log("fused_m3500", **row, launches=json.dumps(counts),
        jax_f32_layers=len(jax["layers"]),
        jax_f32_selected=jax["selected_layer"],
        jax_f32_selected_ate_m=jax["selected_ate"], card=json.dumps(smi))
    if not row["fused"] or row["decisions"] != row["candidates"]:
        raise AssertionError(f"fused_m3500: {row['decisions']} of "
                             f"{row['candidates']} closures decided")
    require_launches("fused_m3500", counts)
    return counts


def fold_inputs(method: int, flags: tuple, candidates: int) -> tuple:
    """``(manager, {width: (poses, masks, iterations)})``: the last folded
    evaluation of each width in the fused engine's run of ``INTEL 50
    METHOD --seed 42 FLAGS`` cut to ``candidates`` closures."""
    mgr = fused_manager("INTEL", 50, 42, method, flags)
    mgr.loop_indices = mgr.loop_indices[:candidates]
    seen, costs = {}, mgr.ss.device_costs

    def record(poses_b, actives_b, num_iters):
        seen[poses_b.shape[0]] = (poses_b, actives_b, num_iters)
        return costs(poses_b, actives_b, num_iters)

    mgr.ss.device_costs = record
    mgr.run()
    return mgr, seen


def looped(ss) -> None:
    """Give ``ss`` the parent's evaluations: one ``lm_fixed_iters`` call
    per candidate where a folded call serves them all."""
    def device_costs(poses_b, actives_b, num_iters):
        return torch.stack([
            ss.device_solve(p, a, ss.free_first.node, num_iters)[1]
            for p, a in zip(poses_b, actives_b)])

    ss.device_costs = device_costs


def fold_run(method: int, mode: str, candidates: int) -> tuple:
    """``(manager, output, wall s, launch counts, peak bytes above those
    held)`` of the fused engine's run of ``INTEL 50 METHOD --seed 42``
    (float32, the Schur eval) cut to ``candidates`` closures, its
    evaluations folded or looped."""
    mgr = fused_manager("INTEL", 50, 42, method)
    mgr.loop_indices = mgr.loop_indices[:candidates]
    if mode == "loop":
        looped(mgr.ss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out, wall, counts = run_manager(mgr)
    return (mgr, out, wall, counts,
            torch.cuda.max_memory_allocated() - held)


def fold_lanes_f64(linear: str, method: int, candidates: int,
                   smi: str) -> None:
    """[manager_fold] (a) on one eval: the last folded batch of each width
    of a float64 fused run of ``INTEL 50 METHOD --seed 42`` on the
    ``linear`` eval cut to ``candidates`` closures, each lane held to its
    solve alone, and the launches of a batched iteration to one lane's
    (on PCG with every lane's CG run to ``eval_pcg_max_iters``, rtol 0,
    so that each lane's count is the batch's)."""
    from slam_tpu_torch.methods import batched

    flags = ("--dtype", "float64", "--eval-linear", linear)
    mgr, seen = fold_inputs(method, flags, candidates)
    ss = mgr.ss
    if ss.cfg.linear_solver != linear or sorted(seen) != sorted(ss.stacked):
        raise AssertionError(
            f"manager_fold m{method} {linear}: the widths {sorted(seen)}, "
            f"the plans {sorted(ss.stacked)}")
    free = ss.free_first.node
    fixed = (ss.cfg.replace(pcg_rtol=0.0) if linear == "pcg" else ss.cfg)
    for width, (P, A, iters) in sorted(seen.items()):
        plan, free_b = ss.batch_plan(width), free.expand(width, -1)

        def fold(n, cfg=ss.cfg, P=P, A=A, plan=plan, free_b=free_b):
            return batched.batched_masked_solve(P, A, free_b, ss.edges, cfg,
                                                n, plan)

        def one(n, k=0, cfg=ss.cfg, P=P, A=A):
            return batched.masked_solve(P[k], A[k], free, ss.edges, cfg, n,
                                        ss.plan)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fp, fc = fold(iters)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        solo = [one(iters, k) for k in range(width)]
        cost_rel = max(abs(fc[k].item() - c.item()) / abs(c.item())
                       for k, (_, c) in enumerate(solo))
        pose_err = max((fp[k] - p).abs().max().item()
                       for k, (p, _) in enumerate(solo))
        per_fold = iteration_launches(lambda n: fold(n, fixed))
        per_lane = iteration_launches(lambda n: one(n, 0, fixed))
        log("manager_fold", part="a", method=method, eval=linear,
            dtype="float64", lanes=width, lm_iterations=iters,
            candidates=candidates, cost_rel_diff=cost_rel,
            pose_max_abs_diff_m=pose_err,
            gates=json.dumps([FOLD_F64_RTOL, FOLD_F64_POSE_ATOL]),
            peak_allocated_bytes=peak,
            launches_per_batched_iteration=json.dumps(per_fold),
            launches_per_lane_iteration=json.dumps(per_lane),
            card=json.dumps(smi))
        if not (cost_rel <= FOLD_F64_RTOL
                and pose_err <= FOLD_F64_POSE_ATOL):
            raise AssertionError(
                f"manager_fold m{method} {linear} x{width}: lanes "
                f"{cost_rel} (cost) and {pose_err} m from their solves "
                "alone")
        if per_fold != per_lane:
            raise AssertionError(
                f"manager_fold m{method} {linear} x{width}: launches "
                f"{per_fold} a batched iteration, {per_lane} a lane's")
    del mgr, ss, seen
    torch.cuda.empty_cache()


def phase_manager_fold(smi: str, timings: list) -> dict:
    """Phase 10d: the managers' candidate evaluations folded into one
    batched short solve.  (a) float64, INTEL+50 seed 42, on the Schur and
    the dense eval: the fused engines' real folded batches (a layering
    step's ten evaluations, a MCTS step's split check and reward), each
    lane held to its solve alone, the launches of one batched iteration
    to one lane's; (b) float32, the fused engines folded against looped,
    in turns; their device times are appended to ``timings``.  Returns
    the launch counts of (b)'s folded runs."""
    for linear in ("schur", "dense"):
        for method in (3, 4):
            fold_lanes_f64(linear, method, FOLD_CANDIDATES, smi)

    total = {}
    for method in (3, 4):
        for mode in ("folded", "loop"):  # warm-up
            fold_run(method, mode, 4)
        runs = {}
        for mode in ("folded", "loop", "loop", "folded"):
            mgr, out, wall, counts, peak = fold_run(method, mode,
                                                    FOLD_CANDIDATES)
            runs.setdefault(mode, []).append(out)
            n = len(mgr.loop_indices)
            log("manager_fold", part="b", method=method, mode=mode,
                dtype=mgr.eval_cfg.dtype, eval=mgr.eval_cfg.linear_solver,
                candidates=n, wall_s=round(wall, 4),
                ms_per_candidate=wall * 1e3 / n,
                calls_per_candidate=mgr.ss.calls / n,
                short_solves_per_candidate=mgr.ss.solves / n,
                launches_per_candidate=json.dumps(
                    {k: c / n for k, c in counts.items()}),
                peak_allocated_bytes=peak, card=json.dumps(smi))
            if mode == "folded":
                for k, c in counts.items():
                    total[k] = total.get(k, 0) + c
        same = [a.assignments == b.assignments for a in runs["folded"]
                for b in runs["loop"]]
        log("manager_fold", part="b", method=method,
            folded_assignments_equal_looped=all(same))

    def device_times():  # profiled in the report, after every other time
        from torch.profiler import ProfilerActivity, profile

        from slam_tpu_torch.tools.profile_lm import device_us

        n = FOLD_PROFILE_CANDIDATES
        for method, mode in ((m, k) for m in (3, 4)
                             for k in ("folded", "loop")):
            wall = fold_run(method, mode, n)[2] * 1e3 / n
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fold_run(method, mode, n)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if device_us(e) > 0]
            dev = sum(device_us(e) for e in events) / 1e3 / n
            log("manager_fold", part="b", method=method, mode=mode,
                candidates=n, device_ms_per_candidate=dev,
                wall_ms_per_candidate=wall, busy_share=dev / wall,
                device_launches_per_candidate=sum(
                    e.count for e in events) / n, card=json.dumps(smi))

    timings.append(lambda: ([], [], device_times))
    require_launches("manager_fold", total)
    return total


def phase_woodbury(device, smi: str) -> dict:
    """Phase 11a: ``INTEL 50 1 --seed 42 --linear-solver woodbury --dtype
    float64`` through the CLI; 50 ``lm_fixed_iters`` of plain DCS on the
    Woodbury solver in float64 (held to its float64 JAX reference) and
    in float32 (finite only)."""
    from slam_tpu_torch import cli
    from slam_tpu_torch.tools.problems import intel50_plain

    got, rounds = {}, []

    def run(save):
        with rescue_rounds(rounds):
            rc = cli.main(["INTEL", "50", "1", "--seed", "42",
                           "--linear-solver", "woodbury", "--dtype",
                           "float64", "--save-path", save])
        if rc != 0:
            raise AssertionError("woodbury_path: cli.main failed")
        logf = os.path.join(save, "method1.log")
        got["solve"] = log_record(logf, "solve")
        got["woodbury"] = log_record(logf, "woodbury")

    counts, wall, poses = run_cli_path("woodbury_path", run)
    ate = golden_ate("woodbury_path", poses)
    log("woodbury_path", wall_s=round(wall, 3), ate_vs_golden_m=ate,
        final_cost=float(got["solve"]["final_cost"]),
        solve_wall_s=got["solve"]["wall_s"],
        lowrank_edges=int(got["woodbury"]["lowrank_edges"]),
        iterations=int(got["solve"]["iterations"]), **round_fields(rounds),
        launches=json.dumps(counts), card=json.dumps(smi))
    if not rounds:
        raise AssertionError("woodbury_path: no batched consensus round")
    if not ate < ATE_GATE_M:
        raise AssertionError(f"woodbury_path: ATE {ate} m >= {ATE_GATE_M} m")
    require_launches("woodbury_path", counts)

    key = "intel50_plain_dcs_woodbury_lm_fixed_iters"
    ref = reference(key)
    iters = ref["iterations"]
    for name in ("float64", "float32"):
        prob = intel50_plain(device, name, "dcs", "woodbury")
        args = (prob.poses0, prob.switches0, prob.edges, prob.free)
        timed_lm(args, prob.scfg, 1, prob.partition)  # warm-up
        res, wall, lm_counts, cost = timed_lm(args, prob.scfg, iters,
                                              prob.partition)
        rel = abs(cost - ref["final_cost"]) / abs(ref["final_cost"])
        log("woodbury_path", dtype=name, final_cost=cost,
            initial_cost=float(res.initial_cost),
            reference_f64=ref["final_cost"], rel_diff=rel,
            gate=WOODBURY_REF_COST_RTOL if name == "float64" else "finite",
            accepted=int(res.accepted), iters=iters, wall_s=round(wall, 4),
            ms_per_iter=round(wall * 1e3 / iters, 4),
            lowrank_edges=prob.partition.num_lowrank,
            launches_per_iter=json.dumps({k: n / iters
                                          for k, n in lm_counts.items()}),
            card=json.dumps(smi))
        if name == "float64":
            held_to("woodbury_path", cost, key, WOODBURY_REF_COST_RTOL)
        elif not np.isfinite(cost):
            raise AssertionError(f"woodbury_path float32: cost {cost}")
    return counts


def phase_sweep(device, smi: str) -> dict:
    """Phase 11b: ``INTEL 50 1 --sweep`` (methods 0 and 1, outlier counts
    0, 10 and 50, seed 0); its (1, 50, 0) cell against the same cell run
    alone."""
    from slam_tpu_torch import cli, ops
    from slam_tpu_torch.config import RunConfig
    from slam_tpu_torch.eval import metrics
    from slam_tpu_torch.io import g2o
    from slam_tpu_torch.methods.global_solve import run_global_solve
    from slam_tpu_torch.utils.logging import RunLogger

    argv = ["INTEL", "50", "1", "--sweep"]
    with tempfile.TemporaryDirectory() as save:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            rc = cli.main([*argv, "--save-path", save])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if rc != 0:
            raise AssertionError(f"sweep: cli.main returned {rc}")
        with open(os.path.join(save, "sweep.json")) as f:
            rows = json.load(f)
    cells = [(r["method"], r["num_outliers"], r["seed"]) for r in rows]
    want = [(m, c, 0) for m in (0, 1) for c in (0, 10, 50)]
    if cells != want:
        raise AssertionError(f"sweep: cells {cells}, not {want}")
    for r in rows:
        vals = [r[k] for k in ("final_cost", "initial_cost", "ate_vs_clean",
                               "collapse_score")]
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"sweep: non-finite row {r}")
        log("sweep", method=r["method"], outliers=r["num_outliers"],
            final_cost=r["final_cost"], iterations=r["iterations"],
            ate_vs_clean_m=r["ate_vs_clean"],
            collapse=r["collapse_score"], wall_s=round(r["wall_s"], 3))
    bad = [r for r in rows
           if r["method"] == 1 and not r["ate_vs_clean"] < ATE_GATE_M]
    if bad:
        raise AssertionError(f"sweep: method-1 ATE >= {ATE_GATE_M} m: {bad}")

    solver = cli.config_from_args(cli.build_parser().parse_args(argv)).solver
    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    quiet = RunLogger(echo=False)
    clean = run_global_solve(graph, RunConfig(
        dataset="INTEL", method=0, num_outliers=0, solver=solver), quiet,
        device=device)
    alone = run_global_solve(graph.add_random_outliers(50, seed=0),
                             RunConfig(dataset="INTEL", method=1,
                                       num_outliers=50, seed=0,
                                       solver=solver), quiet, device=device)
    cell = rows[cells.index((1, 50, 0))]
    got = (float(alone.result.cost), metrics.ate(alone.poses, clean.poses))
    log("sweep", wall_s=round(wall, 3), cells=len(rows),
        cell_1_50_0=json.dumps([cell["final_cost"], cell["ate_vs_clean"]]),
        alone=json.dumps(got), launches=json.dumps(counts),
        card=json.dumps(smi))
    if got != (cell["final_cost"], cell["ate_vs_clean"]):
        raise AssertionError(f"sweep: cell (1, 50, 0) "
                             f"{(cell['final_cost'], cell['ate_vs_clean'])} "
                             f"differs from the run alone {got}")
    require_launches("sweep", counts)
    return counts


def intel50_dataset_graph():
    """INTEL+50 seed 42 at the dataset's poses, canonical order (the
    distributed tests' setting: no init, no padding)."""
    from slam_tpu_torch.io import g2o

    return g2o.load_g2o(g2o.find_dataset("INTEL")).add_random_outliers(
        50, seed=42).canonical_order()


def check_init_multihost() -> None:
    """``init_multihost()`` under torchrun's environment for one rank:
    it joins on the card of the local rank under nccl, the meshes carry
    that card, and a reduction runs there."""
    import socket

    import torch.distributed as tdist

    from slam_tpu_torch.parallel import mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh.init_multihost()
        m = mesh.make_edge_mesh()
        t = torch.ones(4, device=m.device)
        mesh.all_reduce(t, m, mesh.EDGE_AXIS)
        got = dict(backend=tdist.get_backend(), device=str(m.device),
                   block_mesh=str(mesh.make_block_mesh().device),
                   current=torch.cuda.current_device(),
                   reduced=float(t.sum()))
        log("dist_edge", init_multihost=json.dumps(got))
        want = dict(backend="nccl", device="cuda:0", block_mesh="cuda:0",
                    current=0, reduced=4.0)
        if got != want:
            raise AssertionError(f"init_multihost: {got}, not {want}")
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_dist_edge(device, smi: str) -> dict:
    """Phase 11c: ``distributed_lm`` on INTEL+50 at DIST_EDGE_RANKS ranks
    sharing the card (gloo), float64, held to the single-process PCG
    ``lm_fixed_iters`` with the same block-Jacobi preconditioner; then at
    one rank under nccl."""
    from slam_tpu_torch.config import SolverConfig
    from slam_tpu_torch.parallel import distributed, mesh
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph

    g = intel50_dataset_graph()
    cfg = SolverConfig(robust="dcs", linear_solver="pcg", dtype="float64",
                       pcg_max_iters=400, pcg_rtol=1e-10,
                       pcg_preconditioner="jacobi")
    dtype = torch.float64
    edges = edge_set_from_graph(g, dtype=dtype, device=device)
    t0 = time.perf_counter()
    ref = lm_fixed_iters(
        torch.as_tensor(g.poses, dtype=dtype, device=device),
        torch.ones(edges.num_edges, dtype=dtype, device=device), edges,
        anchor_first_node(g.num_nodes, dtype=dtype, device=device), cfg,
        DIST_EDGE_ITERS)
    ref_cost = float(ref.cost)
    ref_wall = time.perf_counter() - t0
    ref_poses = ref.poses.cpu().numpy()
    out = {}
    for phase, ranks, backend in (("dist_edge", DIST_EDGE_RANKS, "gloo"),
                                  ("dist_edge_nccl", 1, None)):
        t0 = time.perf_counter()
        res = mesh.launch(ranks, distributed.edge_lm_job, g, cfg,
                          DIST_EDGE_ITERS, True, device=device,
                          backend=backend, all_ranks=True, timeout=600)
        launch_s = time.perf_counter() - t0
        r = res[0]
        same = mesh.bitwise_equal([x["poses"] for x in res])
        errs = {"cost0": abs(r["cost0"] - float(ref.initial_cost))
                / abs(float(ref.initial_cost)),
                "cost": abs(r["cost"] - ref_cost) / abs(ref_cost),
                "poses": float(np.abs(r["poses"] - ref_poses).max())}
        log(phase, ranks=ranks, backend=r["backend"], cost0=r["cost0"],
            cost=r["cost"], single_process_cost=ref_cost,
            errs=json.dumps(errs), tol=json.dumps(DIST_EDGE_TOL),
            ranks_bitwise_equal=same,
            wall_per_iter_s=max(x["wall_s"] for x in res) / DIST_EDGE_ITERS,
            single_process_wall_per_iter_s=ref_wall / DIST_EDGE_ITERS,
            collectives_per_iter=r["calls"] / DIST_EDGE_ITERS,
            reduced_bytes_per_iter=r["bytes"] / DIST_EDGE_ITERS,
            collective_share=max(x["seconds"] / x["wall_s"] for x in res),
            launches_per_iter_rank0=json.dumps(
                {k: n / DIST_EDGE_ITERS for k, n in r["launches"].items()}),
            launch_s=round(launch_s, 2), launch=json.dumps(mesh.LAST_LAUNCH),
            setup_s=max(x["setup_s"] for x in res), card=json.dumps(smi))
        want = "gloo" if ranks > 1 else "nccl"
        if r["backend"] != want:
            raise AssertionError(f"{phase}: backend {r['backend']}")
        if not same:
            raise AssertionError(f"{phase}: ranks' poses differ")
        bad = {k: v for k, v in errs.items() if not v <= DIST_EDGE_TOL[k]}
        if bad:
            raise AssertionError(f"{phase}: {bad} above {DIST_EDGE_TOL}")
        require_launches(phase, r["launches"])
        out[phase] = r["launches"]
    check_init_multihost()
    return out


def phase_dist_schur(device, smi: str) -> dict:
    """Phase 11d: ``tools/dist_check`` (M3500+50, DIST_SCHUR_RANKS ranks
    sharing the card, gloo, float32, contiguous and spectral) under its
    gates; the replica batch of CSAIL+50 seeds on 2 x 2 ranks against
    each seed alone on 2 ranks, and those, the batch and the first seed
    on 4 ranks (contiguous and spectral) against the single-process
    Schur (float64)."""
    from slam_tpu_torch.config import SolverConfig
    from slam_tpu_torch.io import g2o
    from slam_tpu_torch.parallel import mesh, schur_dist
    from slam_tpu_torch.solver.partition import graph_partition
    from slam_tpu_torch.tools import dist_check

    res = dist_check.run(device, DIST_SCHUR_RANKS, DIST_SCHUR_ITERS,
                         "float32")
    out = {}
    for name, phase in (("contiguous", "dist_schur"),
                        ("spectral", "dist_schur_spectral")):
        r = res[name]
        log("dist_schur", partition=name, ranks=DIST_SCHUR_RANKS,
            backend=r["backend"], ni=r["ni"], ns=r["ns"], ek=r["ek"],
            cost0=r["cost0"], cost=r["cost"],
            single_process_cost0=res["single_process"]["cost0"],
            single_process_cost=res["single_process"]["cost"],
            ranks_bitwise_equal=r["ranks_bitwise_equal"],
            wall_per_iter_s=r["wall_per_iter_s"],
            separator_bytes_per_iter=r["separator_bytes_per_iter"],
            reduced_bytes_per_iter=r["reduced_bytes_per_iter"],
            collectives_per_iter=r["collectives_per_iter"],
            collective_share=r["collective_share"],
            launches_per_iter_rank0=json.dumps(
                {k: n / DIST_SCHUR_ITERS
                 for k, n in r["launches_rank0"].items()}),
            card=json.dumps(smi))
    if not res["ok"]:
        raise AssertionError(
            f"dist_schur: init_ok {res['init_ok']} converged "
            f"{res['converged']} ranks_agree {res['ranks_agree']}")
    log("dist_schur", separator_reduction=res["separator_reduction"],
        single_process_wall_s=res["single_process"]["wall_s"],
        launch_s=round(res["launch_s"], 2),
        launch=json.dumps(mesh.LAST_LAUNCH),
        setup_s=json.dumps([res[k]["setup_s"]
                            for k in ("contiguous", "spectral")]))

    base = g2o.load_g2o(g2o.find_dataset("CSAIL"))
    graphs = [base.add_random_outliers(50, seed=s).canonical_order()
              for s in BATCH_SEEDS]
    cfg = SolverConfig(robust="dcs", linear_solver="schur",
                       dtype="float64")
    nb4 = graph_partition(graphs[0].edges_ij, graphs[0].num_nodes, 4)
    # One launch: the batch, each replica row's seed alone on its 2-rank
    # block group (its own unpadded problem), and the first seed on all
    # 4 ranks, contiguous and spectral.
    res2 = mesh.launch(4, mesh.run_jobs, [
        (schur_dist.batched_schur_lm_job, (graphs, 2, cfg, BATCH_ITERS)),
        (schur_dist.replica_rows_job, (graphs, 2, cfg, BATCH_ITERS)),
        (schur_dist.schur_lm_job, (graphs[0], 4, cfg, BATCH_ITERS)),
        (schur_dist.schur_lm_job, (graphs[0], 4, cfg, BATCH_ITERS, nb4))],
        device=device, all_ranks=True)
    log("dist_schur", batch_launch=json.dumps(mesh.LAST_LAUNCH))
    batch = [r[0] for r in res2]
    b, a = batch[0], res2[0][1]
    for j in range(4):
        if not mesh.bitwise_equal([r[j]["poses"] for r in res2]):
            raise AssertionError(f"dist_schur f64 job {j}: ranks' poses "
                                 "differ")

    def held(what, got, ref):
        errs = {"cost0": abs(got["cost0"] - ref["cost0"]) / ref["cost0"],
                "cost": abs(got["cost"] - ref["cost"]) / ref["cost"],
                "poses": float(np.abs(got["poses"] - ref["poses"]).max())}
        log("dist_schur", float64=what, cost=got["cost"],
            single_process_cost=ref["cost"], errs=json.dumps(errs),
            tol=json.dumps(DIST_SCHUR_F64_TOL))
        bad = {k: v for k, v in errs.items()
               if not v <= DIST_SCHUR_F64_TOL[k]}
        if bad:
            raise AssertionError(f"dist_schur {what}: {bad} above "
                                 f"{DIST_SCHUR_F64_TOL}")

    for i, seed in enumerate(BATCH_SEEDS):
        ref = dist_check.single_process(graphs[i], 2, cfg, BATCH_ITERS,
                                        device)
        for what, r in (("alone2", a), ("batch2x2", b)):
            held(f"{what}_seed{seed}",
                 {k: float(r[k][i]) for k in ("cost0", "cost")}
                 | {"poses": r["poses"][i]}, ref)
    ref4 = dist_check.single_process(graphs[0], 4, cfg, BATCH_ITERS, device)
    for j, what in ((2, "contiguous4"), (3, "spectral4")):
        held(f"{what}_seed{BATCH_SEEDS[0]}", res2[0][j], ref4)
    for i, seed in enumerate(BATCH_SEEDS):
        rel = abs(float(b["cost"][i]) - float(a["cost"][i])) \
            / abs(float(a["cost"][i]))
        log("dist_schur", batch="2x2", seed=seed, cost0=float(b["cost0"][i]),
            cost=float(b["cost"][i]), alone_cost=float(a["cost"][i]),
            rel_diff=rel, gate=BATCH_REL,
            poses_max_abs_diff=float(np.abs(b["poses"][i]
                                            - a["poses"][i]).max()))
        if not rel <= BATCH_REL:
            raise AssertionError(f"dist_schur batch seed {seed}: rel {rel}")
    for name, phase in (("contiguous", "dist_schur"),
                        ("spectral", "dist_schur_spectral")):
        out[phase] = res[name]["launches_rank0"]
        require_launches(phase, out[phase])
    return out


def phase_profile(smi: str) -> dict:
    """Phase 11e: ``INTEL 50 1 --seed 42 --profile DIR`` in a child
    process; the trace holds one event for each of the main path's
    kernel launches (named by its symbol), and the run's final cost and
    optimised poses equal the main path's to the bit.  Returns the kernel
    events of each symbol in the trace."""
    import glob
    import subprocess

    from slam_tpu_torch.io import g2o

    with tempfile.TemporaryDirectory() as tmp:
        trace_dir, save = os.path.join(tmp, "trace"), os.path.join(tmp, "s")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "slam_tpu_torch.cli", "INTEL", "50", "1",
             "--seed", "42", "--profile", trace_dir, "--save-path", save],
            cwd=REPO, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=REPO))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"profile: rc {proc.returncode}\n"
                                 f"{proc.stderr[-3000:]}")
        files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"profile: traces {files}")
        size = os.path.getsize(files[0])
        counts = dict.fromkeys(PROFILE_SYMBOLS, 0)
        tail = b""
        with open(files[0], "rb") as f:
            while chunk := f.read(1 << 24):
                text = tail + chunk
                for k, sym in PROFILE_SYMBOLS.items():
                    counts[k] += text.count(sym.encode())
                # Keep a tail shorter than any symbol, so none is counted
                # twice and none is cut.
                tail = text[-(min(map(len, PROFILE_SYMBOLS.values())) - 1):]
        solve = log_record(os.path.join(save, "method1.log"), "solve")
        poses = g2o.load_nodes(os.path.join(save, "opt_nodes.txt"))
    ate = golden_ate("profile", poses)
    log("profile", wall_s=round(wall, 3), trace_bytes=size,
        kernel_events=json.dumps(counts), final_cost=solve["final_cost"],
        main_path_final_cost=MAIN_RUN["solve"]["final_cost"],
        ate_vs_golden_m=ate, main_path_ate_m=MAIN_RUN["ate"],
        card=json.dumps(smi))
    if solve["final_cost"] != MAIN_RUN["solve"]["final_cost"] \
            or not np.array_equal(poses, MAIN_RUN["poses"]) \
            or ate != MAIN_RUN["ate"]:
        raise AssertionError("profile: the profiled run differs from the "
                             "main path's")
    # One kernel event per launch: the trace holds the main path's.
    if counts != MAIN_RUN["launches"]:
        raise AssertionError(f"profile: kernel events {counts}, main path "
                             f"launches {MAIN_RUN['launches']}")
    require_launches("profile", counts)
    return counts


def require_no_children() -> None:
    """Stop the helpers that launching ranks started, then fail if a
    process this one started is still there (running or unreaped)."""
    from slam_tpu_torch.parallel import mesh

    mesh.shutdown()
    me, left = str(os.getpid()), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:  # ended meanwhile
            continue
        # After the command's closing parenthesis: state, then parent.
        if stat.rsplit(")", 1)[1].split()[1] == me:
            left.append(f"{pid}: {cmd[:200]}")
    log("processes", children_left=len(left))
    if left:
        raise AssertionError(f"processes left running: {left}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from slam_tpu_torch import runtime
    from slam_tpu_torch.ops import _build
    from slam_tpu_torch.tools.kernel_times import card_peaks, nvidia_smi

    t_all = time.perf_counter()
    device = runtime.setup_device("cuda")
    smi = nvidia_smi()
    peaks = card_peaks()
    log("device", nvidia_smi=json.dumps(smi),
        name=json.dumps(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, peak_bytes_per_s=peaks[0],
        peak_f32_ops_per_s=peaks[1][torch.float32],
        peak_f64_ops_per_s=peaks[1][torch.float64])
    t0 = time.perf_counter()
    _build.lib()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        library=os.path.relpath(_build.build_info["path"], REPO),
        compiled=_build.build_info["built"])
    for line in _build.build_info["log"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line \
                or "smem" in line or "Function properties" in line:
            print("  ptxas:", line.strip())

    timings = []
    phases = [
        ("kernels", lambda: phase_kernels(device, peaks, timings)),
        ("stack_chol", lambda: phase_stack_chol(device, peaks, timings)),
        ("main_path", phase_main_path),
        ("plain_dcs", lambda: phase_plain_dcs(device, smi)),
        ("scale", lambda: phase_scale(device, smi)),
        ("blocked", lambda: phase_blocked(device, smi)),
        ("seed_batch", lambda: phase_seed_batch(device, smi, timings)),
        ("rescue_batch", lambda: phase_rescue_batch(device, smi, timings)),
        ("pcg_batch", lambda: phase_pcg_batch(device, smi, timings)),
        ("woodbury_batch", lambda: phase_woodbury_batch(device, smi,
                                                        timings)),
        ("sc_batch", lambda: phase_sc_batch(device, smi, timings)),
        ("method2_path", lambda: phase_method2_path(smi)),
        ("method2_dense", lambda: phase_method2_dense(device, smi)),
        ("method2_ab", lambda: phase_method2_ab(device, smi)),
        ("pcg", lambda: phase_pcg(device, smi)),
        ("report_stages", lambda: phase_report_stages(smi)),
        ("se3_path", lambda: phase_se3_path(smi)),
        ("se3_ab", lambda: phase_se3_ab(device, smi)),
        ("golden", lambda: phase_golden(device, smi)),
        ("managers", lambda: phase_managers(smi)),
        ("fused_managers", lambda: phase_fused_managers(smi)),
        ("fused_vs_host", lambda: phase_fused_vs_host(smi)),
        ("fused_m3500", lambda: phase_fused_m3500(smi)),
        ("manager_fold", lambda: phase_manager_fold(smi, timings)),
        ("woodbury_path", lambda: phase_woodbury(device, smi)),
        ("sweep", lambda: phase_sweep(device, smi)),
        ("dist_edge", lambda: phase_dist_edge(device, smi)),
        ("dist_schur", lambda: phase_dist_schur(device, smi)),
        ("profile", lambda: phase_profile(smi)),
        ("kernel_times", lambda: phase_kernel_times(timings)),
    ]
    out = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        out[name] = fn()
        log(name, phase_s=round(time.perf_counter() - t0, 3))
    require_no_children()
    log("total", seconds=round(time.perf_counter() - t_all, 3))

    launches = {"main_path": out["main_path"],
                "blocked_path": out["blocked"], **out["seed_batch"],
                **out["rescue_batch"], **out["pcg_batch"],
                **out["woodbury_batch"], **out["sc_batch"],
                **out["method2_path"],
                "method2_dense": out["method2_dense"],
                "method2_ab": out["method2_ab"], **out["pcg"],
                "report_stages": out["report_stages"],
                "se3_path": out["se3_path"], "se3_ab": out["se3_ab"],
                "golden": out["golden"], **out["managers"],
                **{p: out[p] for p in ("fused_managers", "fused_vs_host",
                                       "fused_m3500", "manager_fold",
                                       "woodbury_path",
                                       "sweep", "profile")},
                **out["dist_edge"], **out["dist_schur"]}
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[path][KERNEL_COUNTER.get(k, k)],
         **{**out["kernels"], **out["stack_chol"]}[k],
         "launches_by_path": {p: c[KERNEL_COUNTER.get(k, k)]
                              for p, c in launches.items()}}
        for k, (src, tpu, path) in KERNEL_INFO.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
