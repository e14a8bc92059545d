"""Methods 0/1/2: the single global robust solve.

Port of ``slam_tpu/methods/global_solve.py``: read g2o, inject bogus
loops, write ``init_*``; build the robust problem (baseline, DCS or
switchable constraints) with the gauge at pose 0; LM solve; the DCS
psi-consensus rescue and the GNC auto-retry; report (with per-stage times
on request); write ``opt_*`` and, for method 2, ``switches.txt``.  Host
work (ingestion, init, masks, the rescue's random half-subsets) stays in
NumPy; the solves run on the chosen device.

Dropped TPU workarounds: incidence selection and chain compression, the
program-sharing ``rescue_ready`` lanes (the plain solve runs first, then
the chains -- identical results), the accelerator switch to the blocked
Cholesky, and the persistent compile cache.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch import runtime
from slam_tpu_torch.config import METHOD_SC, RunConfig, SolverConfig, \
    solver_config_for_method
from slam_tpu_torch.graph import PoseGraph
from slam_tpu_torch.io import g2o
from slam_tpu_torch.solver import linear
from slam_tpu_torch.solver.linearize import cost_only, loop_psi
from slam_tpu_torch.solver.lm import LMResult, lm_solve
from slam_tpu_torch.solver.models import model_for_dim
from slam_tpu_torch.solver.problem import EdgeSet, FreeMask, \
    anchor_first_node, edge_set_from_graph
from slam_tpu_torch.utils.logging import RunLogger


def _psi_probe(poses, edges, cfg, model) -> np.ndarray:
    """Per-edge DCS psi at ``poses`` -- the rescue trigger probe."""
    return loop_psi(poses, edges, model, cfg.dcs_phi).cpu().numpy()


def _batched_full_cost(results, edges, cfg, model) -> np.ndarray:
    """Common full DCS objective (every live edge) of each candidate."""
    costs = [cost_only(r.poses, r.switches, edges, model=model, robust="dcs",
                       dcs_phi=cfg.dcs_phi, huber_delta=cfg.huber_delta,
                       sc_prior_lambda=cfg.sc_prior_lambda)
             for r in results]
    return torch.stack(costs).cpu().numpy()


@dataclasses.dataclass
class GlobalSolveOutput:
    graph: PoseGraph          # graph with outliers injected
    poses: np.ndarray         # optimized poses
    switches: np.ndarray      # switch values, canonical (padded) edge order
    result: LMResult
    wall_time_s: float


def pick_linear_solver(graph: PoseGraph, robust: str) -> str:
    """Dense up to 512 nodes, partitioned Schur above (the JAX rule)."""
    return "dense" if graph.num_nodes <= 512 else "schur"


class Problem(NamedTuple):
    """A global solve set up on the device (see :func:`setup_problem`)."""

    scfg: SolverConfig
    canon: PoseGraph
    edges: EdgeSet
    free: FreeMask
    poses0: torch.Tensor
    switches0: torch.Tensor
    partition: object  # SchurPartition, WoodburyOps, dense plan, None (pcg)


def setup_problem(
    graph: PoseGraph,
    cfg: RunConfig,
    logger: RunLogger | None = None,
    device: str | torch.device | None = None,
) -> Problem:
    """Initial guess, bucket-padded EdgeSet, gauge and linear-solver plan
    of a method-0/1/2 solve of ``graph``."""
    from slam_tpu_torch.solver.init import apply_init

    runtime.require_type(graph, PoseGraph, "graph")
    runtime.require_type(cfg, RunConfig, "cfg")
    dev = runtime.setup_device(device)
    logger = logger or RunLogger()
    scfg = solver_config_for_method(cfg.method, cfg.solver)
    if scfg.linear_solver == "auto":
        scfg = scfg.replace(
            linear_solver=pick_linear_solver(graph, scfg.robust))
    dtype = getattr(torch, scfg.dtype)

    canon = apply_init(graph.canonical_order(), cfg, logger)
    # Bucket-pad the edge count (inactive padding is free).
    pad_to = -(-canon.num_edges // 256) * 256
    edges = edge_set_from_graph(canon, dtype=dtype, device=dev,
                                pad_to=pad_to)
    free = anchor_first_node(canon.num_nodes, dtype=dtype, device=dev)
    poses0 = torch.as_tensor(canon.poses, dtype=dtype, device=dev)
    # Switch variables initialised to 1.0 (``main.cpp:117``).
    switches0 = torch.ones((edges.num_edges,), dtype=dtype, device=dev)

    partition = None  # pcg needs no plan
    if scfg.linear_solver == "woodbury":
        from slam_tpu_torch.solver.woodbury import build_woodbury_ops

        partition = build_woodbury_ops(edges.ij.cpu().numpy(),
                                       canon.num_nodes, device=dev)
        logger.log("woodbury", lowrank_edges=partition.num_lowrank)
    elif scfg.linear_solver == "schur":
        from slam_tpu_torch.solver.schur import build_partition, \
            choose_partition

        ij = edges.ij.cpu().numpy()
        nblocks, node_block = choose_partition(
            ij, canon.num_nodes,
            tangent_dim=model_for_dim(graph.dim).tangent_dim,
            scheme=scfg.schur_partition)
        # Over the PADDED edge list: pads self-loop on node 0 (a
        # separator) with zero weight, so they are unowned.
        partition = build_partition(ij, canon.num_nodes, nblocks,
                                    dtype=dtype, device=dev,
                                    node_block=node_block)
        logger.log(
            "partition", blocks=nblocks, ni_max=partition.ni_max,
            ns=partition.ns, ek_max=partition.ek_max,
            scheme=("graph" if node_block is not None else "index"),
        )
    elif scfg.linear_solver == "dense":
        partition = linear.dense_plan(edges, switches=scfg.robust == "sc")
    return Problem(scfg, canon, edges, free, poses0, switches0, partition)


def run_global_solve(
    graph: PoseGraph,
    cfg: RunConfig,
    logger: RunLogger | None = None,
    device: str | torch.device | None = None,
) -> GlobalSolveOutput:
    """Solve a (possibly outlier-injected) graph with method 0, 1 or 2."""
    if cfg.method not in (0, 1, 2):
        raise ValueError(
            f"run_global_solve takes methods 0-2, not {cfg.method}; "
            "methods 3 and 4 run through methods.layering and methods.mcts")
    logger = logger or RunLogger()
    prob = setup_problem(graph, cfg, logger, device)
    scfg, edges = prob.scfg, prob.edges
    model = model_for_dim(graph.dim)
    dtype, dev = prob.poses0.dtype, prob.poses0.device

    def solve(es, c):
        return lm_solve(prob.poses0, prob.switches0, es, prob.free, c,
                        model=model, partition=prob.partition)

    t0 = time.perf_counter()
    res = solve(edges, scfg)

    # ---- DCS rescue passes (psi-consensus + GNC retry) -----------------
    # The failure modes and the measured rationale are documented at the
    # same block of the JAX package.  All candidates (plain, each chain's
    # fixed point, GNC) are ranked on the common full objective; the best
    # replaces the plain solve only on a >2% improvement.
    if (scfg.robust == "dcs" and not scfg.gnc_anneal_iters
            and (scfg.dcs_consensus or scfg.dcs_auto_retry)):
        cut = scfg.dcs_consensus_cut
        base_active = edges.active.cpu().numpy()
        live_loop = base_active * edges.is_loop.cpu().numpy()
        n_live = max(float(live_loop.sum()), 1.0)
        psi_plain = _psi_probe(res.poses, edges, scfg, model)
        drop_frac = float((live_loop * (psi_plain < 0.2)).sum() / n_live)
        mean_psi = float((live_loop * psi_plain).sum() / n_live)
        candidates = []  # (tag, result)
        rounds_run = 0

        if (scfg.dcs_consensus
                and drop_frac > scfg.dcs_consensus_drop_frac):
            # Chain 0 trims from the full loop set by the plain solve's
            # psi; chains 1+ start from seeded random half-subsets (the
            # RANSAC move).  Each round re-solves from the original init
            # and re-admits loops whose psi clears the cut, until every
            # chain's mask is a fixed point.  A frozen chain keeps its
            # result: re-solving its mask would give the same bits.
            rng = np.random.default_rng(cfg.seed)
            C = max(1, scfg.dcs_consensus_chains)
            first = [np.where(live_loop > 0,
                              (psi_plain > cut).astype(base_active.dtype),
                              1.0)]
            for _ in range(1, C):
                sub = rng.random(base_active.shape) < 0.5
                first.append(np.where((live_loop > 0) & ~sub, 0.0,
                                      1.0).astype(base_active.dtype))
            cur = np.stack(first)
            fixed = np.zeros(C, dtype=bool)
            chain_res: list = [None] * C
            for _ in range(scfg.dcs_consensus_rounds):
                rounds_run += 1
                for c in range(C):
                    if fixed[c]:
                        continue
                    mask = torch.as_tensor(cur[c] * base_active,
                                           dtype=dtype, device=dev)
                    chain_res[c] = solve(edges._replace(active=mask), scfg)
                    psi_c = _psi_probe(chain_res[c].poses, edges, scfg,
                                       model)
                    new_mask = np.where(
                        live_loop > 0,
                        (psi_c > cut).astype(base_active.dtype), 1.0)
                    if (new_mask == cur[c]).all():
                        fixed[c] = True
                    else:
                        cur[c] = new_mask
                if fixed.all():
                    break
            candidates += [(f"consensus{c}", r)
                           for c, r in enumerate(chain_res)]

        if scfg.dcs_auto_retry and mean_psi < scfg.dcs_retry_threshold:
            retry_cfg = scfg.replace(
                gnc_anneal_iters=scfg.dcs_retry_gnc_iters)
            candidates.append(("gnc", solve(edges, retry_cfg)))

        if candidates:
            costs = _batched_full_cost([res] + [r for _, r in candidates],
                                       edges, scfg, model)
            plain_cost = float(costs[0])
            scored = [(float(costs[1 + i]), tag, r)
                      for i, (tag, r) in enumerate(candidates)]
            best_cost, best_tag, best_res = min(scored, key=lambda x: x[0])
            kept = best_cost < 0.98 * plain_cost
            logger.log(
                "retry", reason="dcs-rescue",
                drop_frac=round(drop_frac, 3),
                mean_psi=round(mean_psi, 3),
                rounds=rounds_run,
                candidates=len(candidates),
                plain_cost=round(plain_cost, 4),
                best_cost=round(best_cost, 4), best=best_tag,
                kept=bool(kept),
            )
            if kept:
                res = best_res
    poses = res.poses.cpu().numpy()
    wall = time.perf_counter() - t0

    logger.log(
        "solve",
        method=cfg.method,
        robust=scfg.robust,
        initial_cost=float(res.initial_cost),
        final_cost=float(res.cost),
        iterations=int(res.iterations),
        accepted=int(res.accepted),
        converged=bool(res.converged),
        linear_iters=int(res.lin_iters),
        wall_s=wall,
    )
    from slam_tpu_torch.solver.report import build_report, measure_stages

    stage_times = None
    if cfg.report_stages:
        stage_times = measure_stages(res.poses, res.switches, edges,
                                     prob.free, scfg, model,
                                     partition=prob.partition)
    report = build_report(res, scfg, wall, stage_times)
    logger.log("report", **report.fields())
    print(report.text())
    return GlobalSolveOutput(
        graph=graph,
        poses=poses,
        switches=res.switches.cpu().numpy(),
        result=res,
        wall_time_s=wall,
    )


def run_from_config(cfg: RunConfig,
                    device: str | torch.device | None = None
                    ) -> GlobalSolveOutput:
    """Full reference-equivalent pipeline with ``save/`` artifacts."""
    os.makedirs(cfg.save_path, exist_ok=True)
    logger = RunLogger(os.path.join(cfg.save_path, f"method{cfg.method}.log"))
    try:
        graph = g2o.load_g2o(g2o.find_dataset(cfg.dataset))
        logger.log("init", dataset=cfg.dataset, **_counts(graph))
        graph = graph.add_random_outliers(cfg.num_outliers, seed=cfg.seed)
        logger.log("inject", num_bogus=cfg.num_outliers, seed=cfg.seed)
        g2o.write_nodes(os.path.join(cfg.save_path, "init_nodes.txt"),
                        graph.poses)
        g2o.write_edges(os.path.join(cfg.save_path, "init_edges.txt"),
                        graph)
        out = run_global_solve(graph, cfg, logger, device=device)
        g2o.write_nodes(os.path.join(cfg.save_path, "opt_nodes.txt"),
                        out.poses)
        g2o.write_edges(os.path.join(cfg.save_path, "opt_edges.txt"), graph)
        if cfg.method == METHOD_SC:
            _write_switches(cfg, graph, out)
    finally:
        logger.close()
    return out


def _write_switches(cfg: RunConfig, graph: PoseGraph,
                    out: GlobalSolveOutput) -> None:
    """``switches.txt`` of a method-2 solve: the loop edges' switches in
    canonical order; for ``sc_varpro``, which eliminated them, ``s*`` of
    the final residuals."""
    canon = graph.canonical_order()
    loop_mask = canon.edge_type != 0
    scfg = solver_config_for_method(cfg.method, cfg.solver)
    if scfg.robust == "sc_varpro":
        from slam_tpu_torch.robust.kernels import sc_varpro_switch

        poses = torch.as_tensor(out.poses, dtype=torch.float64)
        ij = torch.as_tensor(canon.edges_ij, dtype=torch.int64)
        e = model_for_dim(graph.dim).residual(
            poses[ij[:, 0]], poses[ij[:, 1]],
            torch.as_tensor(canon.edges_meas, dtype=torch.float64))
        sw = sc_varpro_switch(e, scfg.sc_prior_lambda).numpy()[
            loop_mask]
    else:
        # out.switches covers the bucket-padded edge list, real edges first.
        sw = out.switches[: loop_mask.shape[0]][loop_mask]
    g2o.write_switches(os.path.join(cfg.save_path, "switches.txt"), graph,
                       priors=np.ones_like(sw), optimized=sw)


def _counts(g: PoseGraph) -> dict:
    return dict(
        nodes=g.num_nodes,
        odometry=g.num_odometry,
        closure=g.num_closure,
        bogus=g.num_bogus,
    )
