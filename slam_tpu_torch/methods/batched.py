"""Short masked LM solves for the layering and MCTS methods.

Port of ``slam_tpu/methods/batched.py``.  The reference's methods 3/4
spend their time in ``evaluate_cost`` / ``evaluate_layer_cost``: a fresh
Ceres problem solved for 1-2 LM iterations per candidate
(``layer_manager.cpp:602-654``, ``simple_layer_manager.cpp:567-622``).
Here a candidate is a (poses, edge-activity mask) pair over the one
canonical :class:`EdgeSet`: ``edges._replace(active=mask)`` keeps its
scatter plans, so no problem is rebuilt.

The JAX package ``vmap``s a batch of candidates into one device program;
here the candidates are folded into one ``lm_fixed_iters`` call over B
copies of the problem (``solver/batch.py``: :func:`batch.candidate_plan`,
:func:`batch.lm_fixed_iters_candidates`), each with its own damping,
acceptance and cost (on PCG its own CG scalars and stopping test), on
the Schur, dense and PCG evals.  A batch's costs stay on the device until
the caller reads them all at once.  Every
function takes the linear plan, which the caller builds once per graph
(:func:`eval_plan`): the single problem's, from which a batch of B
builds its stacked plan, or that stacked plan (a
:class:`batch.CandidatePlan` of B lanes), which a caller that evaluates
batches of one width many times builds once and keeps.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.config import SolverConfig
from slam_tpu_torch.solver import batch, linear
from slam_tpu_torch.solver.lm import lm_fixed_iters
from slam_tpu_torch.solver.problem import EdgeSet, FreeMask

Tensor = torch.Tensor


def eval_plan(cfg: SolverConfig, edges: EdgeSet, graph=None,
              schur_blocks: int = 16):
    """The linear plan of the short solves: the dense assembly plan for
    ``linear_solver="dense"``, one problem's ``linear.PCGPlan`` for PCG,
    and for ``"schur"`` one
    partition of ``graph`` (the canonical graph of ``edges``) that every
    masked solve shares: masked-out edges contribute zero blocks, and a
    node no active edge touches is pinned by the assembly."""
    if cfg.linear_solver == "dense":
        return linear.dense_plan(edges)
    if cfg.linear_solver == "pcg":
        return linear.PCGPlan()
    if cfg.linear_solver == "schur" and graph is not None:
        return schur_plan(graph, cfg, schur_blocks, edges.ij.device)
    raise ValueError("the short solves run on the dense solver or PCG, or "
                     "on the Schur solver given the graph, not "
                     f"{cfg.linear_solver!r}")


def schur_plan(graph, cfg: SolverConfig, num_blocks: int, device):
    """The short solves' Schur partition (the JAX fused engines' rule):
    under ``schur_partition`` "auto"/"graph" the cost model's choice
    between the index and spectral schemes, and ``num_blocks`` index
    blocks whenever the index scheme wins (or is asked for)."""
    from slam_tpu_torch.solver.schur import build_partition, \
        choose_partition

    nblocks, node_block = num_blocks, None
    if cfg.schur_partition in ("auto", "graph"):
        nblocks, node_block = choose_partition(
            graph.edges_ij, graph.num_nodes, tangent_dim=3,
            scheme=cfg.schur_partition)
        if node_block is None:
            nblocks = num_blocks
    return build_partition(graph.edges_ij, graph.num_nodes, nblocks,
                           dtype=getattr(torch, cfg.dtype), device=device,
                           node_block=node_block)


def _check_plan(cfg: SolverConfig, plan) -> None:
    if cfg.linear_solver == "dense" and plan is None:
        raise ValueError("the dense short solves need the plan of "
                         "eval_plan(cfg, edges)")


def stacked_plan(edges: EdgeSet, cfg: SolverConfig, plan,
                 lanes: int) -> batch.CandidatePlan:
    """``plan`` as the stacked plan of ``lanes`` candidates: as given when
    it is one, else built from the single problem's (host reads)."""
    if isinstance(plan, batch.CandidatePlan):
        if plan.lanes != lanes:
            raise ValueError(f"a plan of {plan.lanes} lanes for a batch of "
                             f"{lanes} candidates")
        return plan
    return batch.candidate_plan(edges, cfg, plan, lanes)


def _solve(poses, active, free, edges, cfg, num_iters, plan):
    e = edges._replace(active=active)
    sw = torch.ones((edges.num_edges,), dtype=active.dtype,
                    device=active.device)
    return lm_fixed_iters(poses, sw, e, free, cfg, num_iters,
                          partition=plan)


def _stack(poses_b) -> Tensor:
    return poses_b if isinstance(poses_b, Tensor) else torch.stack(
        list(poses_b))


def batched_eval_cost(
    poses_b,             # (B, N, 3) or B tensors (N, 3): starting poses
    actives_b: Tensor,   # (B, E) edge-activity masks
    edges: EdgeSet,
    free: FreeMask,
    cfg: SolverConfig,
    num_iters: int,
    plan,
) -> Tensor:
    """(B,) final costs of a ``num_iters``-iteration LM solve per
    candidate, on the device (the reference's ``summary.final_cost``:
    after the short solve, Huber-robustified, 0.5-scaled), all B in one
    folded call."""
    _check_plan(cfg, plan)
    poses_b = _stack(poses_b)
    B = poses_b.shape[0]
    return batch.lm_fixed_iters_candidates(
        poses_b, actives_b, free.node.expand(B, -1), cfg, num_iters,
        stacked_plan(edges, cfg, plan, B)).cost


def masked_solve(
    poses: Tensor,       # (N, 3)
    active: Tensor,      # (E,)
    free_node: Tensor,   # (N,) 1.0 = free
    edges: EdgeSet,
    cfg: SolverConfig,
    num_iters: int,
    plan,
) -> tuple[Tensor, Tensor]:
    """Short LM solve of a masked sub-problem; returns (poses, cost).

    The reference's windowed local optimisations
    (``layer_manager.cpp:137-179``, ``simple_layer_manager.cpp:500-565``):
    nodes outside the window are held by the free mask, edges outside are
    inactive -- the semantics of building the sub-problem.  ``plan`` is
    the single problem's."""
    _check_plan(cfg, plan)
    res = _solve(poses, active, FreeMask(node=free_node), edges, cfg,
                 num_iters, plan)
    return res.poses, res.cost


def batched_masked_solve(
    poses_b,              # (B, N, 3) or B tensors (N, 3)
    actives_b: Tensor,    # (B, E)
    free_nodes_b: Tensor,  # (B, N)
    edges: EdgeSet,
    cfg: SolverConfig,
    num_iters: int,
    plan,
) -> tuple[Tensor, Tensor]:
    """:func:`masked_solve` of each of B candidates, in one folded call:
    ((B, N, 3) poses, (B,) costs)."""
    _check_plan(cfg, plan)
    poses_b = _stack(poses_b)
    res = batch.lm_fixed_iters_candidates(
        poses_b, actives_b, free_nodes_b, cfg, num_iters,
        stacked_plan(edges, cfg, plan, poses_b.shape[0]))
    return res.poses, res.cost
