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
     ``MANAGER_KERNEL_CANDIDATES`` closures): a candidate evaluation's
     edge mask with every node but node 0 free, and a windowed commit;
   - ``micro_chol_inv`` on SPD batches of (16, 128, 128) and
     (32, 128, 128), of 48 and 80 such panels (where the kernel takes 2
     and 1 CTAs a matrix), and on real panels: the first and the trailing
     diagonal panel of the equilibrated Schur interiors of INTEL+50,
     M10000+50 and the sphere2500 recipe (D = 6, D ni = 3450) at their
     initial poses, lambda = 1e-4; L bitwise equal to
     the plain version's, the inverse within TOL (SPD) or RESID_FACTOR
     (real panels);
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
   host reads per candidate;
   (b) ``fused_vs_host``: ``CSAIL 50 4 --seed 0`` in float64 with the
   dense eval on the fused and the host engine: the same assignments,
   layers and chosen layers, poses within ``FUSED_VS_HOST_ATOL``;
   (c) ``fused_m3500``: ``M3500 50 4 --seed 0`` on the fused engine,
   whole: every closure decided, finite poses, and its layers, chosen
   layers and ATE beside the JAX float32 record
   (``results/layer_tables/M3500_50out_s0_m4.json``), not gated;
11. the last modules (Woodbury, sweeps, the distributed solvers,
   profiling):
   (a) ``woodbury_path``: ``INTEL 50 1 --seed 42 --linear-solver woodbury
   --dtype float64`` through the CLI, ATE below ``ATE_GATE_M``; 50
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
   INTEL and (32, 128, 128) M10000 batches), and on the SPD batches:
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
                   "micro_chol_inv": "micro_chol_inv_kernel"}
PANEL = 128               # schur_panel of the blocked path
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
}
PHASE_KERNELS = {
    "main_path": ("gather_rows", "scatter_add_rows", "fused_linearize_se2"),
    "blocked_path": ("gather_rows", "scatter_add_rows",
                     "fused_linearize_se2", "micro_chol_inv"),
    "method2_path": ("gather_rows", "scatter_add_rows"),
    "method2_varpro": ("gather_rows", "scatter_add_rows"),
    "method2_dense": ("gather_rows", "scatter_add_rows"),
    "method2_ab": ("gather_rows", "scatter_add_rows", "micro_chol_inv"),
    "pcg_dcs": ("gather_rows", "scatter_add_rows", "fused_linearize_se2"),
    "pcg_sc": ("gather_rows", "scatter_add_rows"),
    "report_stages": ("gather_rows", "scatter_add_rows"),
    "se3_path": ("gather_rows", "scatter_add_rows"),
    "se3_ab": ("gather_rows", "scatter_add_rows", "micro_chol_inv"),
    "golden": ("gather_rows", "scatter_add_rows", "fused_linearize_se2"),
    **{phase: ("gather_rows", "scatter_add_rows", "fused_linearize_se2")
       for phase in (*MANAGER_PHASES, "fused_managers", "fused_vs_host",
                     "fused_m3500", "woodbury_path", "sweep", "dist_edge",
                     "dist_edge_nccl", "dist_schur", "dist_schur_spectral",
                     "profile")},
}
#: What the main path and phase 11's [profile] compare.
MAIN_RUN = {}
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


def real_panels(edges, free, poses, part) -> dict:
    """The first and the trailing diagonal panel that the blocked
    factorisation of the equilibrated interiors hands to the panel factor
    at ``poses`` and lambda = 1e-4."""
    from slam_tpu_torch.solver import blocked_chol as bc
    from slam_tpu_torch.solver.linearize import linearize
    from slam_tpu_torch.solver.models import model_for_dim
    from slam_tpu_torch.solver.schur import assemble

    sw = torch.ones((edges.num_edges,), dtype=poses.dtype,
                    device=poses.device)
    system = linearize(poses, sw, edges, free,
                       model=model_for_dim(poses.shape[-1]), robust="dcs",
                       dcs_phi=0.5, huber_delta=0.01, sc_prior_lambda=1.0)
    A = assemble(system, part, torch.tensor(1e-4, dtype=poses.dtype,
                                            device=poses.device)).A
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


def check_chol(label: str, A, dtype_name: str, gate: str) -> float:
    """Kernel vs plain on one batch; ``gate`` is "spd" (elementwise
    tolerance) or "residual" (against the plain version's residuals).
    Returns the max abs error of L and inv against the plain version."""
    from slam_tpu_torch.ops.chol import micro_chol_inv, micro_chol_inv_plain

    Lk, ik = micro_chol_inv(A)
    torch.cuda.synchronize()
    Lp, ip = micro_chol_inv_plain(A)
    p = A.shape[-1]
    if not torch.equal(Lk, Lp):
        raise AssertionError(f"micro_chol_inv {label} {dtype_name}: L not "
                             "bitwise equal to the plain version's")
    upper = torch.triu(torch.ones(p, p, dtype=torch.bool, device=A.device),
                       1)
    if not (bool((Lk[:, upper] == 0).all()) and bool((ik[:, upper] == 0)
                                                      .all())):
        raise AssertionError(f"micro_chol_inv {label} {dtype_name}: strict "
                             "upper triangle not exactly 0")
    (eL, sL), (ei, si) = max_err(Lk, Lp), max_err(ik, ip)
    rk, rp = residuals(A, Lk, ik), residuals(A, Lp, ip)
    log("kernels", kernel="micro_chol_inv", shape=label, dtype=dtype_name,
        batch=json.dumps(list(A.shape)), err_L=eL, err_inv=ei,
        resid_fac_kernel=rk[0], resid_fac_plain=rp[0],
        resid_inv_kernel=rk[1], resid_inv_plain=rp[1])
    if gate == "spd":
        tol = TOL[A.dtype]
        if not (eL <= tol * sL and ei <= tol * si):
            raise AssertionError(
                f"micro_chol_inv {label} {dtype_name}: err L {eL} (scale "
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
                    f"micro_chol_inv {label} {dtype_name}: residual {what} "
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


def check_short_solves(label: str, ss, cases: dict, dtype) -> None:
    """Each case's LM iteration (``ss``'s configuration and plan)
    recorded and replayed through :func:`check_launches`, its launches
    required, and the linearisation on its masks held to the plain
    version."""
    from slam_tpu_torch.ops.linearize import fused_linearize_se2_indexed, \
        fused_linearize_se2_indexed_plain
    from slam_tpu_torch.tools import kernel_times as kt

    name = str(dtype).replace("torch.", "")
    for kind, args in cases.items():
        what = f"{label}-{kind}"
        poses, _, edges, free = args
        calls, counts, _ = kt.record_iteration(args, ss.cfg, ss.plan)
        missing = [k for k in PHASE_KERNELS["main_path"]
                   if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{what} {name}: {missing} not launched")
        scatter_err = check_launches(calls, what, name)
        lin = (ss.cfg.dcs_phi, ss.cfg.huber_delta)
        got = fused_linearize_se2_indexed(
            poses, free.node, edges, *lin, robust=ss.cfg.robust)
        torch.cuda.synchronize()
        errs = linearize_errs(
            f"{what} {name}", got, fused_linearize_se2_indexed_plain(
                poses, free.node, edges.ab, edges.meas, edges.loop_f,
                edges.active, *lin, ss.cfg.robust), dtype)
        plan = ({"dense_unknowns": 3 * poses.shape[0]}
                if ss.cfg.linear_solver == "dense" else
                {"plan": ss.cfg.linear_solver})
        log("kernels", shape=what, dtype=name, **plan,
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
            check_short_solves(f"{cell}-m{method}", ss, cases, dtype)
    for cell, graph in fused_graphs.items():
        ss, cases = fused_solve_inputs(graph, device, name,
                                       MANAGER_KERNEL_CANDIDATES)
        if ss.cfg.linear_solver != "schur" or set(cases) != {"candidate",
                                                             "window"}:
            raise AssertionError(f"{cell} fused: {ss.cfg.linear_solver} "
                                 f"plan, cases {sorted(cases)}")
        check_short_solves(f"{cell}-fused-m3", ss, cases, dtype)


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


def time_chol(A, err: float, peaks, summary):
    """Times of ``micro_chol_inv`` on one SPD batch against its plain
    version and the library pair; with ``summary``, the result line's.
    Returns ``(rows, fns, report)`` for :func:`phase_kernel_times`."""
    from slam_tpu_torch.ops.chol import micro_chol_inv, micro_chol_inv_plain
    from slam_tpu_torch.tools import kernel_times as kt

    m = A.shape[0]
    nbytes, ops, library = kt.chol_work(A)
    t = in_turns({"kernel": lambda: micro_chol_inv(A),
                  "plain": lambda: micro_chol_inv_plain(A),
                  "library": library},
                 {"kernel": REPS, "plain": 3, "library": REPS})
    b_ms, b_by = kt.bound(peaks, A.dtype, nbytes, ops)
    row = dict(max_abs_err=err, ms=t["kernel"],
               host_us=kt.host_us(lambda: micro_chol_inv(A), REPS),
               plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by,
               library_ms=t["library"])

    def report():
        log("kernels", kernel="micro_chol_inv", shape=f"spd{m}",
            dtype=str(A.dtype).replace("torch.", ""), max_abs_err=err,
            ms=round(row["ms"], 5),
            device_ms=round(row["device_ms"], 5),
            host_us=round(row["host_us"], 2),
            plain_ms=round(row["plain_ms"], 5),
            library_ms=round(row["library_ms"], 5), bound_ms=round(b_ms, 6),
            bound_by=b_by)
        if summary is not None:
            summary["micro_chol_inv"] = {
                k: v for k, v in row.items() if k != "device_events"}

    return [row], [lambda: micro_chol_inv(A)], report


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
        # timed; and at larger batches, where the kernel takes 2 and 1
        # CTAs a matrix (4 m and 2 m past the SM count).
        for m in (16, 32, 48, 80):
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
    return summary


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


def phase_main_path() -> dict:
    from slam_tpu_torch import cli

    def run(save):
        rc = cli.main(["INTEL", "50", "1", "--seed", "42", "--save-path",
                       save])
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        MAIN_RUN["solve"] = log_record(os.path.join(save, "method1.log"),
                                       "solve")

    counts, wall, poses = run_cli_path("main_path", run)
    ate = golden_ate("main_path", poses)
    MAIN_RUN.update(poses=poses, ate=ate, launches=counts)
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
    def run(save):
        run_from_config(RunConfig(
            dataset="INTEL", num_outliers=50, method=1, seed=42,
            save_path=save, solver=SolverConfig(
                dtype="float32", **CONFIGS["blocked_micro"])),
            device=device)

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
        cg = res.lin_iters
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
    # exception, counted (not refused) under the mode "warn".
    mgr = fused_manager("INTEL", 50, 42, 4, ("--eval-linear", "pcg"))
    mgr.loop_indices = mgr.loop_indices[:FUSED_PCG_CANDIDATES]
    syncs = []
    with chunks_under_sync_mode("warn"), count_syncs(syncs):
        _, wall, counts = run_manager(mgr)
    if mgr.eval_cfg.linear_solver != "pcg" or not syncs:
        raise AssertionError(f"fused_pcg: {mgr.eval_cfg.linear_solver} "
                             f"eval, {len(syncs)} host reads")
    log("fused_pcg", cell="intel50_m4", candidates=FUSED_PCG_CANDIDATES,
        wall_s=round(wall, 3), s_per_candidate=wall / FUSED_PCG_CANDIDATES,
        short_solves=mgr.ss.solves, lm_iterations=mgr.ss.iterations,
        host_reads_per_candidate=len(syncs) / FUSED_PCG_CANDIDATES,
        launches=json.dumps(counts), card=json.dumps(smi))
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
                layers=len(out.layers), best=out.best_layer,
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


def phase_woodbury(device, smi: str) -> dict:
    """Phase 11a: ``INTEL 50 1 --seed 42 --linear-solver woodbury --dtype
    float64`` through the CLI; 50 ``lm_fixed_iters`` of plain DCS on the
    Woodbury solver in float64 (held to its float64 JAX reference) and
    in float32 (finite only)."""
    from slam_tpu_torch import cli
    from slam_tpu_torch.tools.problems import intel50_plain

    got = {}

    def run(save):
        if cli.main(["INTEL", "50", "1", "--seed", "42", "--linear-solver",
                     "woodbury", "--dtype", "float64", "--save-path",
                     save]) != 0:
            raise AssertionError("woodbury_path: cli.main failed")
        logf = os.path.join(save, "method1.log")
        got["solve"] = log_record(logf, "solve")
        got["woodbury"] = log_record(logf, "woodbury")

    counts, wall, poses = run_cli_path("woodbury_path", run)
    ate = golden_ate("woodbury_path", poses)
    log("woodbury_path", wall_s=round(wall, 3), ate_vs_golden_m=ate,
        final_cost=float(got["solve"]["final_cost"]),
        lowrank_edges=int(got["woodbury"]["lowrank_edges"]),
        iterations=int(got["solve"]["iterations"]),
        launches=json.dumps(counts), card=json.dumps(smi))
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
        ("main_path", phase_main_path),
        ("plain_dcs", lambda: phase_plain_dcs(device, smi)),
        ("scale", lambda: phase_scale(device, smi)),
        ("blocked", lambda: phase_blocked(device, smi)),
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
                "blocked_path": out["blocked"], **out["method2_path"],
                "method2_dense": out["method2_dense"],
                "method2_ab": out["method2_ab"], **out["pcg"],
                "report_stages": out["report_stages"],
                "se3_path": out["se3_path"], "se3_ab": out["se3_ab"],
                "golden": out["golden"], **out["managers"],
                **{p: out[p] for p in ("fused_managers", "fused_vs_host",
                                       "fused_m3500", "woodbury_path",
                                       "sweep", "profile")},
                **out["dist_edge"], **out["dist_schur"]}
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[path][k], **out["kernels"][k],
         "launches_by_path": {p: c[k] for p, c in launches.items()}}
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
