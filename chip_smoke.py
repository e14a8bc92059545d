#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its seconds and numbers; any failed gate raises, so
the script exits non-zero and prints no result line):

1. device and build: ``nvidia-smi`` name and power limit, then the nvcc
   build of every kernel in ``slam_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (INTEL+50 and M10000+50, real poses and edges), in
   float32 and float64, with CUDA-event times of both;
3. the main path through the CLI, ``INTEL 50 1 --seed 42`` (auto init,
   auto solver = Schur, rescue on, float32): the output files, the launch
   count of every kernel during that run, and the ATE against the golden
   trajectory;
4. plain DCS on INTEL+50 (no rescue), 50 ``lm_fixed_iters`` iterations,
   held against the float64 JAX reference cost in
   ``slam_tpu_torch/data/reference_costs.json``;
5. scale: M10000+50, dataset init, auto partition, 50 ``lm_fixed_iters``
   iterations in one call: cost <= 0.8 x initial, and LM iterations/s.

Then one JSON line of per-kernel results, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
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
# Main-path gates.
ATE_GATE_M = 0.8          # tests/test_golden.py: rescued vs 4.24 m poisoned
REF_COST_RTOL = 1e-3      # float32 card vs float64 JAX reference
SCALE_COST_FRAC = 0.8     # M10000: cost <= 0.8 x initial
KERNEL_INFO = {
    "gather_rows": ("slam_tpu_torch/csrc/gather.cu",
                    "slam_tpu/ops/pallas_gather.py:56"),
    "scatter_add_rows": ("slam_tpu_torch/csrc/gather.cu",
                         "slam_tpu/ops/pallas_gather.py:95"),
    "fused_linearize_se2": ("slam_tpu_torch/csrc/linearize_se2.cu",
                            "slam_tpu/ops/pallas_linearize.py:203"),
}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> tuple[float, float]:
    """(max abs error, max(1, max |b|)) of two tensors."""
    err = (a - b).abs().max().item() if a.numel() else 0.0
    scale = max(1.0, b.abs().max().item() if b.numel() else 0.0)
    return err, scale


def intel_problem(device, dtype_name: str, **solver_kw):
    from slam_tpu.config import RunConfig, SolverConfig
    from slam_tpu.io import g2o
    from slam_tpu.utils.logging import RunLogger
    from slam_tpu_torch.methods.global_solve import setup_problem

    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    graph = graph.add_random_outliers(50, seed=42)
    cfg = RunConfig(dataset="INTEL", num_outliers=50, method=1, seed=42,
                    solver=SolverConfig(dtype=dtype_name, **solver_kw))
    return setup_problem(graph, cfg, RunLogger(echo=False), device)


def m10000_problem(device, dtype):
    from slam_tpu.io import g2o
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph

    graph = g2o.load_g2o(os.path.join(REPO, "data", "M10000.g2o"))
    dirty = graph.add_random_outliers(50, seed=0).canonical_order()
    edges = edge_set_from_graph(dirty, dtype=dtype, device=device)
    free = anchor_first_node(dirty.num_nodes, dtype=dtype, device=device)
    poses0 = torch.as_tensor(dirty.poses, dtype=dtype, device=device)
    return dirty, edges, free, poses0


def phase_kernels(device) -> dict:
    """Kernel vs plain at the main path's shapes; returns the INTEL float32
    numbers per kernel for the result line."""
    from slam_tpu_torch.ops.gather import gather_rows, gather_rows_plain, \
        scatter_add_rows, scatter_add_rows_plain
    from slam_tpu_torch.ops.linearize import fused_linearize_se2, \
        fused_linearize_se2_plain

    summary = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        shapes = {"INTEL": intel_problem(device, name,
                                         linear_solver="dense")}
        _, m_edges, m_free, m_poses = m10000_problem(device, dtype)
        shapes["M10000"] = (m_edges, m_free, m_poses)
        for label, prob in shapes.items():
            if label == "INTEL":
                edges, free, poses = prob.edges, prob.free, prob.poses0
            else:
                edges, free, poses = prob
            idx = edges.plan_a.idx
            pa = gather_rows_plain(poses, edges.plan_a.idx)
            pb = gather_rows_plain(poses, edges.plan_b.idx)
            lin_args = (pa, pb, edges.meas,
                        gather_rows_plain(free.node, edges.plan_a.idx),
                        gather_rows_plain(free.node, edges.plan_b.idx),
                        edges.is_loop.to(dtype), edges.active, 0.5, 0.01)
            results = {}

            g_k = gather_rows(poses, idx)
            torch.cuda.synchronize()
            g_p = gather_rows_plain(poses, idx)
            if not torch.equal(g_k, g_p):
                raise AssertionError(f"gather_rows {label} {name}: not "
                                     "bitwise equal to the plain version")
            results["gather_rows"] = (0.0, lambda: gather_rows(poses, idx),
                                      lambda: gather_rows_plain(poses, idx))

            for robust in ("dcs", "none"):
                l_k = fused_linearize_se2(*lin_args, robust=robust)
                torch.cuda.synchronize()
                l_p = fused_linearize_se2_plain(*lin_args, robust=robust)
                errs = {k: max_err(l_k[k], l_p[k]) for k in l_p}
                bad = {k: v for k, v in errs.items()
                       if not v[0] <= TOL[dtype] * v[1]}
                if bad:
                    raise AssertionError(
                        f"fused_linearize_se2 {label} {name} {robust}: "
                        f"(err, scale) above {TOL[dtype]} x scale: {bad}")
                err = max(e for e, _ in errs.values())
                if robust == "dcs":
                    results["fused_linearize_se2"] = (
                        err,
                        lambda: fused_linearize_se2(*lin_args,
                                                    robust="dcs"),
                        lambda: fused_linearize_se2_plain(*lin_args,
                                                          robust="dcs"))

            v = l_p["Haa"].reshape(-1, 9).contiguous()
            s_k = scatter_add_rows(v, edges.plan_a)
            s_k2 = scatter_add_rows(v, edges.plan_a)
            torch.cuda.synchronize()
            s_p = scatter_add_rows_plain(v, edges.plan_a)
            err, scale = max_err(s_k, s_p)
            if not err <= TOL[dtype] * scale:
                raise AssertionError(f"scatter_add_rows {label} {name}: "
                                     f"err {err} > {TOL[dtype]} x {scale}")
            if not torch.equal(s_k, s_k2):
                raise AssertionError(f"scatter_add_rows {label} {name}: "
                                     "two runs differ")
            results["scatter_add_rows"] = (
                err, lambda: scatter_add_rows(v, edges.plan_a),
                lambda: scatter_add_rows_plain(v, edges.plan_a))

            for kname, (err, fk, fp) in results.items():
                ms_p1 = cuda_ms(fp)
                ms_k1 = cuda_ms(fk)
                ms_k2 = cuda_ms(fk)
                ms_p2 = cuda_ms(fp)
                ms, plain_ms = (ms_k1 + ms_k2) / 2, (ms_p1 + ms_p2) / 2
                log("kernels", kernel=kname, shape=label, dtype=name,
                    edges=edges.num_edges, nodes=poses.shape[0],
                    max_abs_err=err, ms=round(ms, 5),
                    plain_ms=round(plain_ms, 5))
                if label == "INTEL" and dtype == torch.float32:
                    summary[kname] = dict(max_abs_err=err, ms=ms,
                                          plain_ms=plain_ms)
    return summary


def phase_main_path() -> dict:
    from slam_tpu.eval import metrics
    from slam_tpu.io import g2o
    from slam_tpu_torch import cli, ops

    with tempfile.TemporaryDirectory() as save:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(["INTEL", "50", "1", "--seed", "42",
                       "--save-path", save])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        for fname in ("init_nodes.txt", "init_edges.txt", "opt_nodes.txt",
                      "opt_edges.txt"):
            if not os.path.isfile(os.path.join(save, fname)):
                raise AssertionError(f"main path wrote no {fname}")
        poses = g2o.load_nodes(os.path.join(save, "opt_nodes.txt"))
    golden = np.load(os.path.join(REPO, "results", "golden",
                                  "INTEL_50out_seed42.npy"))
    if poses.shape != golden.shape or not np.isfinite(poses).all():
        raise AssertionError(f"opt_nodes shape {poses.shape} or non-finite")
    ate = metrics.ate(poses, golden)
    log("main_path", wall_s=round(wall, 3), ate_vs_golden_m=ate,
        launches=json.dumps(counts))
    if not ate < ATE_GATE_M:
        raise AssertionError(f"ATE {ate} m >= {ATE_GATE_M} m")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return counts


def phase_plain_dcs(device, smi: str) -> None:
    from slam_tpu_torch.solver.lm import lm_fixed_iters

    with open(os.path.join(REPO, "slam_tpu_torch", "data",
                           "reference_costs.json")) as f:
        ref = json.load(f)["intel50_plain_dcs_lm_fixed_iters"]
    prob = intel_problem(device, "float32", dcs_consensus=False,
                         dcs_auto_retry=False)
    iters = ref["iterations"]
    args = (prob.poses0, prob.switches0, prob.edges, prob.free, prob.scfg)
    lm_fixed_iters(*args, 2, partition=prob.partition)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lm_fixed_iters(*args, iters, partition=prob.partition)
    cost = float(res.cost)
    wall = time.perf_counter() - t0
    rel = abs(cost - ref["final_cost"]) / abs(ref["final_cost"])
    log("plain_dcs", initial_cost=float(res.initial_cost), final_cost=cost,
        reference_f64=ref["final_cost"], rel_diff=rel,
        accepted=int(res.accepted), iters=iters, wall_s=round(wall, 4),
        lm_it_per_s=round(iters / wall, 2), card=json.dumps(smi))
    if not rel <= REF_COST_RTOL:
        raise AssertionError(f"plain DCS cost {cost} vs reference "
                             f"{ref['final_cost']}: rel {rel}")


def phase_scale(device, smi: str) -> None:
    from slam_tpu.config import SolverConfig
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.solver.schur import build_partition, \
        choose_partition

    t0 = time.perf_counter()
    dirty, edges, free, poses0 = m10000_problem(device, torch.float32)
    cfg = SolverConfig(robust="dcs", linear_solver="schur", dtype="float32")
    nblocks, node_block = choose_partition(dirty.edges_ij, dirty.num_nodes)
    part = build_partition(dirty.edges_ij, dirty.num_nodes, nblocks,
                           dtype=torch.float32, device=device,
                           node_block=node_block)
    sw0 = torch.ones((edges.num_edges,), dtype=torch.float32, device=device)
    setup = time.perf_counter() - t0
    lm_fixed_iters(poses0, sw0, edges, free, cfg, 2, partition=part)
    torch.cuda.synchronize()
    iters = 50
    t0 = time.perf_counter()
    res = lm_fixed_iters(poses0, sw0, edges, free, cfg, iters,
                         partition=part)
    cost, cost0 = float(res.cost), float(res.initial_cost)
    wall = time.perf_counter() - t0
    log("scale", nodes=dirty.num_nodes, edges=edges.num_edges,
        blocks=nblocks, scheme="graph" if node_block is not None else "index",
        ni_max=part.ni_max, ns=part.ns, nsk_max=part.nsk_max,
        setup_s=round(setup, 3), initial_cost=cost0, final_cost=cost,
        accepted=int(res.accepted), iters=iters, wall_s=round(wall, 4),
        lm_it_per_s=round(iters / wall, 3), card=json.dumps(smi))
    if not (np.isfinite(cost) and cost <= SCALE_COST_FRAC * cost0):
        raise AssertionError(f"M10000 cost {cost} > {SCALE_COST_FRAC} x "
                             f"{cost0}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from slam_tpu_torch import runtime
    from slam_tpu_torch.ops import _build

    t_all = time.perf_counter()
    device = runtime.setup_device("cuda")
    smi = nvidia_smi()
    log("device", nvidia_smi=json.dumps(smi),
        name=json.dumps(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    t0 = time.perf_counter()
    _build.lib()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        library=os.path.relpath(_build.build_info["path"], REPO),
        compiled=_build.build_info["built"])
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    t0 = time.perf_counter()
    summary = phase_kernels(device)
    log("kernels", phase_s=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    counts = phase_main_path()
    log("main_path", phase_s=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    phase_plain_dcs(device, smi)
    log("plain_dcs", phase_s=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    phase_scale(device, smi)
    log("scale", phase_s=round(time.perf_counter() - t0, 3))
    log("total", seconds=round(time.perf_counter() - t_all, 3))

    kernels = [
        {"name": k, "route": "cuda", "source": KERNEL_INFO[k][0],
         "replaces": KERNEL_INFO[k][1], "launches": counts[k],
         **summary[k]}
        for k in KERNEL_INFO
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
