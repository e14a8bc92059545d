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
     M10000+50 (real poses and edges), and of INTEL+50 under method 2 on
   the Schur, dense and PCG solvers, recorded and replayed: each
     gather bitwise equal to ``index_select``; each grouped scatter
     launch bitwise equal to itself run again and to its groups launched
     one at a time, and within TOL of its plain version;
   - the linearisation at the same shapes: the solver's indexed entry
     (the kernel reads the endpoints itself) and the JAX-shaped entry on
     gathered inputs, each within TOL of its plain version and the two
     bitwise equal;
   - ``micro_chol_inv`` on SPD batches of (16, 128, 128) and
     (32, 128, 128), of 48 and 80 such panels (where the kernel takes 2
     and 1 CTAs a matrix), and on real panels: the first and the trailing
     diagonal panel of the equilibrated Schur interiors of INTEL+50 and
     M10000+50 at their initial poses, lambda = 1e-4; L bitwise equal to
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
8. the kernels' times, after the end-to-end phases and with every
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
Then one JSON line of per-kernel results, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile
import time

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
}
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
    from slam_tpu_torch.solver.models import SE2Model
    from slam_tpu_torch.solver.schur import assemble

    sw = torch.ones((edges.num_edges,), dtype=poses.dtype,
                    device=poses.device)
    system = linearize(poses, sw, edges, free, model=SE2Model, robust="dcs",
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
    """Phase 8: the host-sensitive times of every job first, then all the
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
    from slam_tpu_torch.tools.problems import CONFIGS, intel50, \
        intel50_plain, m10000

    summary = {}
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
                    errs = {k: max_err(got[k], plain[k]) for k in plain}
                    bad = {k: v for k, v in errs.items()
                           if not v[0] <= TOL[dtype] * v[1]}
                    if bad:
                        raise AssertionError(
                            f"fused_linearize_se2 {what} {label} {name} "
                            f"{robust}: (err, scale) above {TOL[dtype]} x "
                            f"scale: {bad}")
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

    counts, wall, poses = run_cli_path("main_path", run)
    ate = golden_ate("main_path", poses)
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
        ("kernel_times", lambda: phase_kernel_times(timings)),
    ]
    out = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        out[name] = fn()
        log(name, phase_s=round(time.perf_counter() - t0, 3))
    log("total", seconds=round(time.perf_counter() - t_all, 3))

    launches = {"main_path": out["main_path"],
                "blocked_path": out["blocked"], **out["method2_path"],
                "method2_dense": out["method2_dense"],
                "method2_ab": out["method2_ab"], **out["pcg"],
                "report_stages": out["report_stages"]}
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
