"""B problems in one LM solve: the per-seed batch, the chain batch and
the candidate batch.

Port of the JAX package's batched solves: B seeds' problems of one dataset
(``bench.py``, ``scripts/bench_variants.py``), stacked
(``jax.tree.map(jnp.stack)``) and run as one ``jax.vmap(lm_fixed_iters)``;
the DCS rescue's consensus round (``_chain_solve_batch`` in
``slam_tpu/methods/global_solve.py``), ``jax.vmap(lm_solve)`` over C
chains' active masks of one problem; and a method-3/4 manager step's
candidate evaluations (``slam_tpu/methods/batched.py``, the fused engines'
``vmap`` over their specs), ``jax.vmap(lm_fixed_iters)`` over B
candidates' start poses, active masks and free masks of one problem.
Here stacking is concatenation:

- the edge set is one :class:`EdgeSet` of B*E edges over B*N nodes,
  problem b's edges at ``[b*E, (b+1)*E)`` with endpoints offset by
  ``b*N``, each seed's edges padded to E with inactive ones
  (:func:`seed_batch`), or C copies of one edge set that differ only in
  ``active`` (:func:`chain_batch`; a round sets the masks with
  ``edges._replace(active=...)``, so no plan is rebuilt), or B such
  copies whose start poses and free masks differ too
  (:func:`candidate_plan`, built once per width and kept; each call sets
  the poses and the masks);
- the free mask is each problem's, stacked (a node that no active edge
  of its lane touches is pinned by the assembly, lane by lane, as in a
  single solve);
- the Schur partition holds each problem's (``build_slots(pad_shapes=...)``,
  the maxima of ``partition_stats``, for seeds) as B*P interior blocks
  and B separators of ``D*ns`` (``schur.partition_from_slots(seeds=B)``),
  not the partition of the disjoint union, whose one separator of
  ``B*D*ns`` would cost B^2 times the factor work;
- the dense plan (``linear.dense_plan(seeds=B)``) puts each problem's
  pose-only system in its own matrix of a ``(B, D*N, D*N)`` stack, and
  under joint switchable constraints (``switches=True``) its joint
  pose-and-switch system, each switch placed by its index in its own
  problem;
- PCG's plan (``linear.PCGPlan(seeds=B)``) gives each problem its own CG
  scalars and stopping test; the cyclic-reduction preconditioner reduces
  each problem's chain on a lane axis (``solver/tridiag.py``);
- the Woodbury operators (``woodbury.build_woodbury_ops(seeds=B)``) hold
  each problem's low-rank edges, padded to the problems' largest count
  with columns that add nothing (``scripts/bench_woodbury.py``'s
  ``pad_to``); each problem's K x K core is factored on its own.

:func:`batch_plan` builds a plan of the B problems of an edge set for
each solver but Schur, whose partition the seeds' slot maps make.

:func:`lm_fixed_iters_batch` and :func:`lm_solve_batch` run every problem's
LM with its own damping, acceptance and cost, as the ``vmap`` does
(``lm_fixed_iters`` and ``lm_solve`` read the seed axis from the plan;
``lm_solve`` stops each at its own convergence), and each kernel launch of
an iteration serves all B problems: one linearisation over the B*E edges,
the gathers and scatters of one problem's iteration, and on the blocked
path one ``micro_chol_inv`` launch per diagonal panel for the B*P
interiors (``micro_chol_inv_folded``); on PCG one gather and one
grouped scatter per CG matvec for all B problems, the loop running as
long as its slowest problem.  A single problem's arithmetic is
unchanged.  The batch takes the Schur, dense, PCG and Woodbury solvers
with every ``robust`` mode: under joint SC (``sc``) the Schur and Woodbury
solvers eliminate each problem's switches with its own damping, the dense
solver factors each problem's joint system, and PCG runs the joint system
as alone.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from slam_tpu_torch.config import SolverConfig
from slam_tpu_torch.graph import PoseGraph
from slam_tpu_torch.runtime import require_type
from slam_tpu_torch.solver import linear, schur, woodbury
from slam_tpu_torch.solver.lm import LMResult, lm_fixed_iters, lm_solve
from slam_tpu_torch.solver.problem import EdgeSet, FreeMask, \
    edge_set_from_arrays, padded_edge_arrays

Tensor = torch.Tensor

#: The plan types each linear solver's batch takes (the dense solver's
#: pose-only or joint plan, as ``robust`` asks).
PLANS = {"schur": schur.SchurPartition,
         "dense": (linear.DenseBatchPlan, linear.JointPlan),
         "pcg": linear.PCGPlan, "woodbury": woodbury.WoodburyOps}


class SeedBatch(NamedTuple):
    """B seeds' problems stacked for :func:`lm_fixed_iters_batch`: the
    Schur partition here, the other solvers' plans by
    :func:`batch_plan`."""

    poses0: Tensor        # (B, N, D) each seed's initial poses
    switches0: Tensor     # (B, E)
    edges: EdgeSet        # B*E edges over B*N nodes
    free: FreeMask        # (B*N,)
    partition: schur.SchurPartition  # seeds=B
    pad_shapes: tuple     # (ni, ns, ek, es, nsk) shared by the seeds

    @property
    def seeds(self) -> int:
        return self.poses0.shape[0]

    @property
    def args(self) -> tuple:
        """``(poses0, switches0, edges, free)``."""
        return self.poses0, self.switches0, self.edges, self.free


def _offset(a: np.ndarray, k: int) -> np.ndarray:
    """``a + k`` where ``a`` holds an index, ``-1`` (padding) kept."""
    return np.where(a >= 0, a + k, -1)


def stack_slots(slots: Sequence[schur.SlotMaps]) -> schur.SlotMaps:
    """One seed batch's slot maps from each seed's, all padded to one
    shape: node, edge and separator slot ids offset by each seed's
    ``b*N``, ``b*E`` and ``b*ns``; block-local slots unchanged."""
    s0 = slots[0]
    N, E, ns = s0.num_nodes, s0.num_edges, s0.sep_ids.shape[0]
    for s in slots:
        if (s.num_nodes, s.num_edges) != (N, E) or any(
                getattr(s, f).shape != getattr(s0, f).shape
                for f in schur.SlotMaps._fields[:11]):
            raise ValueError("the seeds' slot maps differ in shape: build "
                             "them with one pad_shapes")

    def cat(field, step=0):
        return np.concatenate([_offset(getattr(s, field), b * step)
                               if step else getattr(s, field)
                               for b, s in enumerate(slots)])

    return schur.SlotMaps(
        int_ids=cat("int_ids", N), sep_ids=cat("sep_ids", N),
        edge_ids=cat("edge_ids", E), int_a=cat("int_a"), int_b=cat("int_b"),
        sep_a=cat("sep_a"), sep_b=cat("sep_b"), loc_ids=cat("loc_ids", ns),
        sepedge_ids=cat("sepedge_ids", E), se_sep_a=cat("se_sep_a", ns),
        se_sep_b=cat("se_sep_b", ns), num_nodes=len(slots) * N,
        num_edges=len(slots) * E)


def seed_batch(graphs: Sequence[PoseGraph], num_blocks: int,
               dtype=torch.float64, device="cpu") -> SeedBatch:
    """Stack the seeds' graphs (one dataset: the same nodes; edges in
    canonical order, padded to the most any seed has), node 0 of each
    anchored, each seed's ``num_blocks`` index-range partition padded to
    the maxima of ``partition_stats`` over the seeds (as ``bench.py``
    builds its batch)."""
    for g in graphs:
        require_type(g, PoseGraph, "graphs[]")
    gs = [g.canonical_order() for g in graphs]
    N, dim = gs[0].poses.shape
    if any(g.poses.shape != (N, dim) for g in gs):
        raise ValueError("the seeds' graphs differ in their nodes")
    E = max(g.num_edges for g in gs)
    arrays = [padded_edge_arrays(g, E) for g in gs]
    stats = [schur.partition_stats(a["ij"], N, num_blocks) for a in arrays]
    pad = tuple(max(st[i] for st in stats) for i in range(len(stats[0])))
    slots = [schur.build_slots(a["ij"], N, num_blocks, pad_shapes=pad)
             for a in arrays]
    B = len(gs)
    edges = edge_set_from_arrays(
        ij=np.concatenate([a["ij"] + b * N for b, a in enumerate(arrays)]),
        **{k: np.concatenate([a[k] for a in arrays])
           for k in ("meas", "is_loop", "active", "info")},
        num_nodes=B * N, dtype=dtype, device=device)
    node = torch.ones((B, N), dtype=dtype, device=device)
    node[:, 0] = 0.0
    return SeedBatch(
        poses0=torch.as_tensor(np.stack([g.poses for g in gs]), dtype=dtype,
                               device=device),
        switches0=torch.ones((B, E), dtype=dtype, device=device),
        edges=edges, free=FreeMask(node=node.reshape(-1)),
        partition=schur.partition_from_slots(
            stack_slots(slots), dtype=dtype, device=device, seeds=B),
        pad_shapes=pad)


def batch_plan(edges: EdgeSet, linear_solver: str, seeds: int,
               robust: str = "dcs"):
    """The plan of ``seeds`` problems of one size in ``edges`` (a seed
    batch's, or copies of one problem) for a solver other than Schur: the
    dense batch plan (the joint one for ``robust="sc"``), PCG's, or the
    Woodbury operators padded to the problems' largest low-rank count
    (``scripts/bench_woodbury.py``'s recipe; copies of one problem need
    no padding)."""
    if linear_solver == "dense":
        return linear.dense_plan(edges, switches=robust == "sc",
                                 seeds=seeds)
    if linear_solver == "pcg":
        return linear.PCGPlan(seeds)
    if linear_solver == "woodbury":
        return woodbury.build_woodbury_ops(
            edges.ij.cpu().numpy(), edges.num_nodes,
            device=edges.ij.device, seeds=seeds)
    raise ValueError(f"no batch plan of {linear_solver!r} here: the Schur "
                     "partition is built from the problems' slot maps")


def stack_edges(edges: EdgeSet, copies: int) -> EdgeSet:
    """``copies`` copies of ``edges`` as one edge set of ``copies*E`` edges
    over ``copies*N`` nodes, copy k's endpoints offset by ``k*N``."""
    N = edges.num_nodes

    def tile(t):
        a = t.cpu().numpy()
        return np.tile(a, (copies,) + (1,) * (a.ndim - 1))

    ij = edges.ij.cpu().numpy().astype(np.int64)
    return edge_set_from_arrays(
        ij=(ij[None] + N * np.arange(copies)[:, None, None]).reshape(-1, 2),
        meas=tile(edges.meas), is_loop=tile(edges.loop_f) != 0,
        active=tile(edges.active), info=tile(edges.info),
        num_nodes=copies * N, dtype=edges.meas.dtype,
        device=edges.meas.device)


class ChainBatch(NamedTuple):
    """C copies of one problem for :func:`lm_solve_batch`, which differ
    only in their ``active`` masks (the DCS rescue's chains)."""

    poses0: Tensor        # (C, N, D) the problem's initial poses, C times
    switches0: Tensor     # (C, E)
    edges: EdgeSet        # C*E edges over C*N nodes, the problem's masks
    free: FreeMask        # (C*N,)
    partition: object     # a plan of PLANS, seeds=C

    @property
    def chains(self) -> int:
        return self.poses0.shape[0]

    def masked(self, masks) -> EdgeSet:
        """The edge set with chain c's edges under ``masks[c]`` (C, E)."""
        return self.edges._replace(active=torch.as_tensor(
            masks, dtype=self.edges.active.dtype,
            device=self.edges.active.device).reshape(-1))


def chain_batch(poses0: Tensor, switches0: Tensor, edges: EdgeSet,
                free: FreeMask, cfg: SolverConfig, partition,
                chains: int) -> ChainBatch:
    """``chains`` copies of one problem and its plan (the problem's Schur
    partition stacked, or :func:`batch_plan`), built once for every round
    of a rescue."""
    C = chains
    plan = candidate_plan(edges, cfg, partition, C)
    return ChainBatch(
        poses0=poses0.unsqueeze(0).repeat(C, 1, 1),
        switches0=switches0.unsqueeze(0).repeat(C, 1),
        edges=plan.edges, free=FreeMask(node=free.node.repeat(C)),
        partition=plan.partition)


class CandidatePlan(NamedTuple):
    """The plan of B candidate evaluations of one problem for
    :func:`lm_fixed_iters_candidates`: B copies of its edge set, whose
    ``active`` masks each call sets, and the stacked partition.  Built
    once per width (its edge set and plan read the host) and kept."""

    edges: EdgeSet        # B*E edges over B*N nodes
    partition: object     # a plan of PLANS, seeds=B

    @property
    def lanes(self) -> int:
        return self.partition.seeds


def candidate_plan(edges: EdgeSet, cfg: SolverConfig, partition,
                   lanes: int) -> CandidatePlan:
    """``lanes`` copies of ``edges`` and of the problem's plan: its Schur
    partition stacked (``partition`` is the single problem's), or
    :func:`batch_plan` of the copies."""
    _check_solver(cfg)
    es = stack_edges(edges, lanes)
    if cfg.linear_solver == "schur":
        plan = schur.partition_from_slots(
            stack_slots([partition.slots] * lanes),
            dtype=edges.meas.dtype, device=edges.meas.device, seeds=lanes)
    else:
        plan = batch_plan(es, cfg.linear_solver, lanes, cfg.robust)
    return CandidatePlan(edges=es, partition=plan)


def lm_fixed_iters_candidates(poses_b: Tensor, actives_b: Tensor,
                              free_b: Tensor, cfg: SolverConfig,
                              num_iters: int,
                              plan: CandidatePlan) -> LMResult:
    """``num_iters`` LM iterations of each of B candidates of one problem,
    no host read inside (on PCG but its stopping flag), as
    ``jax.vmap(lm_fixed_iters)`` runs them:
    ``poses_b`` (B, N, D) their start poses, ``actives_b`` (B, E) their
    edge masks, ``free_b`` (B, N) their free masks (1 = free); every
    switch 1.  Shapes of the result as :func:`lm_fixed_iters_batch`."""
    B, N, dim = poses_b.shape
    if plan.lanes != B or actives_b.shape != (B, plan.edges.num_edges // B) \
            or free_b.shape != (B, N):
        raise ValueError(f"{B} candidates of {N} nodes (masks "
                         f"{tuple(actives_b.shape)}, free masks "
                         f"{tuple(free_b.shape)}) do not match the plan's "
                         f"{plan.lanes} lanes of {plan.edges.num_edges} "
                         "edges")
    active = actives_b.reshape(-1).to(plan.edges.active.dtype)
    return lm_fixed_iters_batch(
        poses_b, torch.ones_like(actives_b, dtype=poses_b.dtype),
        plan.edges._replace(active=active),
        FreeMask(node=free_b.reshape(-1)), cfg, num_iters, plan.partition)


def lane(res: LMResult, k: int) -> LMResult:
    """Problem ``k``'s result of a batched solve."""
    return type(res)(*(v[k] if isinstance(v, Tensor) else v for v in res))


def _check_solver(cfg: SolverConfig) -> None:
    """Raise for a linear solver that the batch does not know."""
    require_type(cfg, SolverConfig, "cfg")
    if cfg.linear_solver not in PLANS:
        raise ValueError(f"unknown linear solver {cfg.linear_solver!r}")


def _flat(poses0: Tensor, switches0: Tensor, edges: EdgeSet,
          cfg: SolverConfig, partition) -> tuple:
    """Check a batch's inputs; returns ``(B, N, D, E)``."""
    _check_solver(cfg)
    if not isinstance(partition, PLANS[cfg.linear_solver]) \
            or partition.seeds is None:
        raise ValueError("the seed batch needs its stacked partition "
                         "(seed_batch(...).partition, "
                         "chain_batch(...).partition or "
                         "batch_plan(edges, solver, B, robust))")
    B, N, dim = poses0.shape
    E = switches0.shape[-1]
    if partition.seeds != B or edges.num_nodes != B * N \
            or edges.num_edges != B * E:
        raise ValueError(f"{B} seeds of {N} nodes and {E} edges do not "
                         f"match the edge set ({edges.num_nodes} nodes, "
                         f"{edges.num_edges} edges) and the partition's "
                         f"{partition.seeds} seeds")
    return B, N, dim, E


def _stacked(res: LMResult, B: int, N: int, dim: int, E: int) -> LMResult:
    return res._replace(poses=res.poses.reshape(B, N, dim),
                        switches=res.switches.reshape(B, E))


def lm_fixed_iters_batch(poses0: Tensor, switches0: Tensor, edges: EdgeSet,
                         free: FreeMask, cfg: SolverConfig, num_iters: int,
                         partition) -> LMResult:
    """Exactly ``num_iters`` LM iterations of each of B seeds, no host
    read inside (on PCG but its stopping flag): ``lm_fixed_iters`` on the
    batch's flat problem, which
    runs every seed as ``jax.vmap(lm_fixed_iters)`` does.  ``poses0`` is
    ``(B, N, D)``, ``switches0`` ``(B, E)``; the result's poses are
    ``(B, N, D)``, switches ``(B, E)``, and cost, initial cost, accepted
    steps, lambda, nu and the inner (CG) iterations ``(B,)``."""
    B, N, dim, E = _flat(poses0, switches0, edges, cfg, partition)
    res = lm_fixed_iters(poses0.reshape(B * N, dim),
                         switches0.reshape(B * E), edges, free, cfg,
                         num_iters, partition=partition)
    return _stacked(res, B, N, dim, E)


def lm_solve_batch(poses0: Tensor, switches0: Tensor, edges: EdgeSet,
                   free: FreeMask, cfg: SolverConfig,
                   partition) -> LMResult:
    """LM to each problem's own convergence (or ``cfg.max_iterations``):
    ``lm_solve`` on the batch's flat problem, which runs every problem as
    ``jax.vmap(lm_solve)`` does, with one host read an iteration (whether
    any is still running).  Shapes as :func:`lm_fixed_iters_batch`, and
    iterations, accepted steps and ``converged`` ``(B,)``."""
    B, N, dim, E = _flat(poses0, switches0, edges, cfg, partition)
    res = lm_solve(poses0.reshape(B * N, dim), switches0.reshape(B * E),
                   edges, free, cfg, partition=partition)
    return _stacked(res, B, N, dim, E)
