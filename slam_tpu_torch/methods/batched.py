"""Short masked LM solves for the layering and MCTS methods.

Port of ``slam_tpu/methods/batched.py``.  The reference's methods 3/4
spend their time in ``evaluate_cost`` / ``evaluate_layer_cost``: a fresh
Ceres problem solved for 1-2 LM iterations per candidate
(``layer_manager.cpp:602-654``, ``simple_layer_manager.cpp:567-622``).
Here a candidate is a (poses, edge-activity mask) pair over the one
canonical :class:`EdgeSet`: ``edges._replace(active=mask)`` keeps its
scatter plans, so no problem is rebuilt.

The JAX package ``vmap``s the batch into one device program; here each
candidate is its own :func:`lm_fixed_iters` call, and a batch's costs stay
on the device until the caller reads them all at once.  Every function
takes the linear plan, which the caller builds once per graph
(:func:`eval_plan`), so no call re-plans the dense assembly.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.config import SolverConfig
from slam_tpu_torch.solver import linear
from slam_tpu_torch.solver.lm import lm_fixed_iters
from slam_tpu_torch.solver.problem import EdgeSet, FreeMask

Tensor = torch.Tensor


def eval_plan(cfg: SolverConfig, edges: EdgeSet, graph=None,
              schur_blocks: int = 16):
    """The linear plan of the short solves: the dense assembly plan for
    ``linear_solver="dense"``, nothing for PCG, and for ``"schur"`` one
    partition of ``graph`` (the canonical graph of ``edges``) that every
    masked solve shares: masked-out edges contribute zero blocks, and a
    node no active edge touches is pinned by the assembly."""
    if cfg.linear_solver == "dense":
        return linear.dense_plan(edges)
    if cfg.linear_solver == "pcg":
        return None
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


def _solve(poses, active, free, edges, cfg, num_iters, plan):
    e = edges._replace(active=active)
    sw = torch.ones((edges.num_edges,), dtype=active.dtype,
                    device=active.device)
    return lm_fixed_iters(poses, sw, e, free, cfg, num_iters,
                          partition=plan)


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
    after the short solve, Huber-robustified, 0.5-scaled)."""
    _check_plan(cfg, plan)
    return torch.stack([
        _solve(poses, active, free, edges, cfg, num_iters, plan).cost
        for poses, active in zip(poses_b, actives_b)])


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
    inactive -- the semantics of building the sub-problem."""
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
    """:func:`masked_solve` of each of B candidates: ((B, N, 3) poses,
    (B,) costs)."""
    _check_plan(cfg, plan)
    out = [_solve(p, a, FreeMask(node=f), edges, cfg, num_iters, plan)
           for p, a, f in zip(poses_b, actives_b, free_nodes_b)]
    return (torch.stack([r.poses for r in out]),
            torch.stack([r.cost for r in out]))
