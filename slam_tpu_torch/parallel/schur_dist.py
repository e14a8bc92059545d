"""Distributed Schur-complement LM on ``torch.distributed``.

Port of ``slam_tpu/parallel/schur_dist.py``.  The pose graph is cut into
map blocks, one block per rank.  Each rank owns its block's edges (those
with an interior endpoint of the block, and a round-robin share of the
edges between separator nodes), linearises them, eliminates its interior
with a dense Cholesky, and the separator system is reduced over the
ranks:

    per rank:    A_k = J_int^T W J_int,  F_k = J_int^T W J_sep,
                 C_k, b_k, b_sep_k   (local edges only)
    all_reduce:  S   = sum(C_k - F_k^T A_k^-1 F_k) + damp_sep
                 rhs = sum(b_sep_k - F_k^T A_k^-1 b_k)
    replicated:  solve S x_sep = rhs  (every rank)
    per rank:    x_int_k = A_k^-1 (b_k - F_k x_sep)
    all_reduce:  pose update = sum(scatter x_int_k) + scatter x_sep

Every edge lives on one rank, so each reduction is a plain sum of
partials; the cost, the damping diagonal and the interior update are
reduced as well.  Each decision (accept/reject, lambda) is taken from
all-reduced values, so every rank takes the same branch and ends with the
same poses to the bit.

The node and edge assignment (``_assign_dist``) is the JAX package's,
copied verbatim, so both give the same ``(ni, ns, ek)`` and edge owners.
The JAX shard body builds its Jacobians densely through one-hot products
(``inc_int_*``, ``inc_sep_*``, ``int_sel``, ``sep_sel``); here each
rank's :class:`DistSchurShard` holds slot maps as scatter plans, and A,
F, C_k, b_k and b_sep_k come from one grouped ``scatter_add_rows``
launch of the per-edge D x D blocks into block grids, as the
single-device ``solver/schur.py`` assembles.  Unknowns are node-major
(slot * D + coordinate), where the JAX package's are coordinate-major, so
only the solutions compare.  The block and separator factors are
``cholesky_ex``, as the JAX code factors with ``cho_factor``.  Joint SC
folds the exact per-edge switch elimination into the per-edge blocks
before the scatter (no extra collective).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.config import SolverConfig
from slam_tpu_torch.graph import ODOMETRY_EDGE, PoseGraph
from slam_tpu_torch.ops.gather import SegmentPlan, gather_rows, \
    scatter_add_groups, segment_plan
from slam_tpu_torch.parallel.mesh import BLOCK_AXIS, REPLICA_AXIS, Mesh, \
    all_gather, all_reduce
from slam_tpu_torch.runtime import require_type
from slam_tpu_torch.solver.linear import _DIAG_MAX, _DIAG_MIN, \
    nan_unless_factored
from slam_tpu_torch.solver.linearize import cost_only, linearize
from slam_tpu_torch.solver.models import model_for_dim
from slam_tpu_torch.solver.problem import EdgeSet, FreeMask, \
    edge_set_from_arrays
from slam_tpu_torch.solver.schur import _block_entries, _grad_entries

Tensor = torch.Tensor


class DistSchurProblem(NamedTuple):
    """Host-built per-block problem data (NumPy), leading axis P = number
    of blocks = ranks (and a batch axis before it from
    :func:`build_dist_problem_batch`).  ``-1`` marks padding in the slot
    maps; padded edge rows are inactive (0, 0) edges.

    * ``ij``, ``meas``, ``is_loop``, ``active``, ``info`` (P, ek, ...):
      each block's edges
    * ``int_a``/``int_b`` (P, ek): the block's interior slot of each
      endpoint
    * ``sep_a``/``sep_b`` (P, ek): the separator slot of each endpoint
    * ``int_ids`` (P, ni): node of each interior slot
    * ``sep_ids`` (ns,): node of each separator slot
    """

    ij: np.ndarray
    meas: np.ndarray
    is_loop: np.ndarray
    active: np.ndarray
    info: np.ndarray
    int_a: np.ndarray
    int_b: np.ndarray
    sep_a: np.ndarray
    sep_b: np.ndarray
    int_ids: np.ndarray
    sep_ids: np.ndarray

    @property
    def num_blocks(self) -> int:
        return self.int_ids.shape[-2]

    @property
    def ni(self) -> int:
        return self.int_ids.shape[-1]

    @property
    def ns(self) -> int:
        return self.sep_ids.shape[-1]

    @property
    def ek(self) -> int:
        return self.ij.shape[-2]

    def replica(self, i: int) -> "DistSchurProblem":
        """Problem ``i`` of a batch."""
        return DistSchurProblem(*(x[i] for x in self))


def _assign_dist(g: PoseGraph, num_blocks: int,
                 node_block: np.ndarray | None = None):
    """Shared node/edge assignment for the distributed problem builder:
    ``(node_block, sep_ids, interior_ids, per_block_edges)``.  One source
    of truth so :func:`dist_problem_stats` can never desync from
    :func:`build_dist_problem`.  ``node_block`` overrides the contiguous
    equal-size assignment (e.g. ``solver.partition.graph_partition`` --
    the separator system is all-reduced every iteration, so the spectral
    cut's smaller ns shrinks the dominant collective too).  Copied from
    the JAX package; where it asserts ``node_block``, this raises
    ``ValueError`` and also checks that every block id is >= 0."""
    ij = g.edges_ij
    n = g.num_nodes
    E = g.num_edges
    if node_block is None:
        block_size = -(-n // num_blocks)
        node_block = np.minimum(np.arange(n) // block_size, num_blocks - 1)
    else:
        node_block = np.asarray(node_block, np.int64)
        if node_block.shape != (n,) or (n and (
                node_block.min() < 0 or node_block.max() >= num_blocks)):
            raise ValueError(
                f"node_block must be ({n},) block ids in [0, {num_blocks})")
    ba, bb = node_block[ij[:, 0]], node_block[ij[:, 1]]
    sep = np.zeros(n, bool)
    cross = ba != bb
    sep[ij[cross, 0]] = True
    sep[ij[cross, 1]] = True
    sep[0] = True

    sep_ids = np.where(sep)[0]
    interior_ids = [
        np.where((node_block == k) & ~sep)[0] for k in range(num_blocks)
    ]

    owner = np.full(E, -1)
    a_int = ~sep[ij[:, 0]]
    b_int = ~sep[ij[:, 1]]
    owner[a_int] = ba[a_int]
    sel = b_int & (owner < 0)
    owner[sel] = bb[sel]
    # Pure-separator edges: deal them round-robin across devices.
    pure = np.where(owner < 0)[0]
    owner[pure] = np.arange(len(pure)) % num_blocks
    per_block = [np.where(owner == k)[0] for k in range(num_blocks)]
    return node_block, sep_ids, interior_ids, per_block


def dist_problem_stats(
    graph: PoseGraph, num_blocks: int,
    node_block: np.ndarray | None = None,
) -> tuple[int, int, int]:
    """Natural ``(ni, ns, ek)`` of :func:`build_dist_problem` -- use to
    compute shared ``pad_shapes`` across problems (e.g. outlier seeds)."""
    g = graph.canonical_order()
    _, sep_ids, interior_ids, per_block = _assign_dist(g, num_blocks,
                                                       node_block)
    ni = max(1, max(len(x) for x in interior_ids))
    ek = max(1, max(len(x) for x in per_block))
    return ni, len(sep_ids), ek


def build_dist_problem(
    graph: PoseGraph,
    num_blocks: int,
    pad_shapes: tuple[int, int, int] | None = None,
    node_block: np.ndarray | None = None,
) -> DistSchurProblem:
    """Partition and per-block edge shards (every edge on one block),
    contiguous blocks unless ``node_block`` is given.  ``pad_shapes=(ni,
    ns, ek)`` pads to shared maxima so problems on different graphs (same
    N) can be stacked for :func:`distributed_batched_schur_lm`; padded
    separator slots are pinned with identity inside the solve."""
    require_type(graph, PoseGraph, "graph")
    g = graph.canonical_order()
    ij = g.edges_ij.astype(np.int64)
    n = g.num_nodes
    P = num_blocks
    node_block, sep_ids, interior_ids, per_block = _assign_dist(
        g, num_blocks, node_block)
    ns = len(sep_ids)
    sep_slot = np.full(n, -1)
    sep_slot[sep_ids] = np.arange(ns)
    ni = max(1, max(len(x) for x in interior_ids))
    int_slot = np.full(n, -1)
    for ids in interior_ids:
        int_slot[ids] = np.arange(len(ids))
    ek = max(1, max(len(x) for x in per_block))
    ns_pad = ns
    if pad_shapes is not None:
        tni, tns, tek = pad_shapes
        if not (tni >= ni and tns >= ns and tek >= ek):
            raise ValueError(
                "pad_shapes smaller than this problem's natural sizes")
        ni, ek, ns_pad = tni, tek, tns

    def padded(field, fill=0):
        out = np.full((P, ek) + field.shape[1:], fill, field.dtype)
        for k, ids in enumerate(per_block):
            out[k, :len(ids)] = field[ids]
        return out

    meas = padded(g.edges_meas)
    if g.edges_meas.shape[1] == 7:
        # Identity quaternion on padded SE(3) rows: a zero quaternion
        # NaNs under normalisation even at weight 0.
        for k, ids in enumerate(per_block):
            meas[k, len(ids):, 3] = 1.0
    active = np.zeros((P, ek))
    maps = {name: np.full((P, ek), -1, np.int64)
            for name in ("int_a", "int_b", "sep_a", "sep_b")}
    for k, ids in enumerate(per_block):
        active[k, :len(ids)] = 1.0
        for col, iname, sname in ((0, "int_a", "sep_a"),
                                  (1, "int_b", "sep_b")):
            ep = ij[ids, col]
            own = (int_slot[ep] >= 0) & (node_block[ep] == k)
            maps[iname][k, :len(ids)] = np.where(own, int_slot[ep], -1)
            maps[sname][k, :len(ids)] = sep_slot[ep]
    int_ids = np.full((P, ni), -1, np.int64)
    for k, ids in enumerate(interior_ids):
        int_ids[k, :len(ids)] = ids
    sep_ids_p = np.full(ns_pad, -1, np.int64)
    sep_ids_p[:ns] = sep_ids
    return DistSchurProblem(
        ij=padded(ij.astype(np.int32)), meas=meas,
        is_loop=padded(g.edge_type != ODOMETRY_EDGE),
        active=active, info=padded(g.edges_info), int_ids=int_ids,
        sep_ids=sep_ids_p, **maps)


def build_dist_problem_batch(graphs, num_blocks: int) -> DistSchurProblem:
    """Stack per-seed :func:`build_dist_problem` outputs, padded to shared
    shapes, for :func:`distributed_batched_schur_lm`."""
    stats = [dist_problem_stats(g, num_blocks) for g in graphs]
    pad = tuple(max(s[i] for s in stats) for i in range(3))
    probs = [build_dist_problem(g, num_blocks, pad_shapes=pad)
             for g in graphs]
    return DistSchurProblem(*(np.stack(xs) for xs in zip(*probs)))


class DistSchurShard(NamedTuple):
    """One block of a :class:`DistSchurProblem` on a rank's device.
    Per-edge sources are the block rows ``[Haa, Hbb, Hab, Hba]`` (4 ek)
    and the gradients ``[ga, gb]`` (2 ek)."""

    edges: EdgeSet       # the block's edges, plans over all N nodes
    node_gather: Tensor  # (ni + ns,) int32 node of each interior and
    #                      separator slot (pad 0)
    int_mask: Tensor     # (ni,) 1 for real interior slots
    sep_live: Tensor     # (ns,) 1 for real separator slots
    plan_A: SegmentPlan    # 4 ek block rows -> (ni, ni) block grid
    plan_F: SegmentPlan    # 4 ek block rows -> (ni, ns) block grid
    plan_b: SegmentPlan    # 2 ek gradient rows -> (ni,)
    plan_C: SegmentPlan    # 4 ek block rows -> (ns, ns) block grid
    plan_bs: SegmentPlan   # 2 ek gradient rows -> (ns,)
    plan_int: SegmentPlan  # interior slots -> nodes
    plan_sep: SegmentPlan  # separator slots -> nodes


def shard_problem(prob: DistSchurProblem, block: int, num_nodes: int,
                  dtype=torch.float64, device="cpu") -> DistSchurShard:
    """Block ``block`` of ``prob`` with its scatter plans on ``device``."""
    ni, ns, ek = prob.ni, prob.ns, prob.ek
    k = block
    e = np.where(prob.active[k] > 0, np.arange(ek), -1)
    ia, ib = prob.int_a[k], prob.int_b[k]
    sa, sb = prob.sep_a[k], prob.sep_b[k]

    def plan(idx, n, src, grid=None):
        return segment_plan(idx, n, src=src, device=device, grid=grid)

    r, c, src, _ = _block_entries(e, ia, ib, ek)
    plan_A = plan(r * ni + c, ni * ni, src, ((), ni, ni))
    ok_ab = (e >= 0) & (ia >= 0) & (sb >= 0)
    ok_ba = (e >= 0) & (ib >= 0) & (sa >= 0)
    plan_F = plan(np.concatenate([ia[ok_ab] * ns + sb[ok_ab],
                                  ib[ok_ba] * ns + sa[ok_ba]]), ni * ns,
                  np.concatenate([2 * ek + e[ok_ab], 3 * ek + e[ok_ba]]),
                  ((), ni, ns))
    rows, src, _ = _grad_entries(e, ia, ib, ek)
    plan_b = plan(rows, ni, src)
    r, c, src, _ = _block_entries(e, sa, sb, ek)
    plan_C = plan(r * ns + c, ns * ns, src, ((), ns, ns))
    rows, src, _ = _grad_entries(e, sa, sb, ek)
    plan_bs = plan(rows, ns, src)
    int_ids, sep_ids = prob.int_ids[k], prob.sep_ids
    oi, os_ = int_ids >= 0, sep_ids >= 0
    edges = edge_set_from_arrays(
        ij=prob.ij[k], meas=prob.meas[k], is_loop=prob.is_loop[k],
        active=prob.active[k], info=prob.info[k], num_nodes=num_nodes,
        dtype=dtype, device=device)
    return DistSchurShard(
        edges=edges,
        node_gather=torch.as_tensor(np.maximum(np.concatenate(
            [int_ids, sep_ids]), 0).astype(np.int32), device=device),
        int_mask=torch.as_tensor(oi.astype(np.float64), dtype=dtype,
                                 device=device),
        sep_live=torch.as_tensor(os_.astype(np.float64), dtype=dtype,
                                 device=device),
        plan_A=plan_A, plan_F=plan_F, plan_b=plan_b, plan_C=plan_C,
        plan_bs=plan_bs,
        plan_int=plan(int_ids[oi], num_nodes, np.flatnonzero(oi)),
        plan_sep=plan(sep_ids[os_], num_nodes, np.flatnonzero(os_)))


def _schur_lm_shard(poses: Tensor, shard: DistSchurShard, free: FreeMask,
                    cfg: SolverConfig, mesh: Mesh, num_iters: int, model,
                    axis: str = BLOCK_AXIS):
    """This rank's block of the partitioned-Schur LM; the collectives run
    over ``axis``.  Returns ``(poses, cost, cost0, switches (ek,))``,
    poses and costs replicated over the axis."""
    local = shard.edges
    dtype, dev = poses.dtype, poses.device
    N, D = poses.shape[0], model.tangent_dim
    ni, ns = shard.int_mask.shape[0], shard.sep_live.shape[0]
    ek = local.num_edges
    kw = dict(model=model, robust=cfg.robust, dcs_phi=cfg.dcs_phi,
              huber_delta=cfg.huber_delta,
              sc_prior_lambda=cfg.sc_prior_lambda)
    is_sc = cfg.robust == "sc"

    def reduce(t):
        return all_reduce(t.contiguous(), mesh, axis)

    sw = torch.ones_like(local.active)
    cost = reduce(cost_only(poses, sw, local, **kw).reshape(1))[0]
    cost0 = cost
    lam = torch.full((), cfg.init_lambda, dtype=dtype, device=dev)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    for _ in range(num_iters):
        sys_l = linearize(poses, sw, local, free, fixed_identity_scale=0.0,
                          **kw)
        red = reduce(torch.cat([
            torch.diagonal(sys_l.Hdiag, dim1=-2, dim2=-1).reshape(-1),
            sys_l.cost.reshape(1)]))
        dnode, cost_here = red[:-1].reshape(N, D), red[-1]

        # Damping, Jacobi equilibration and pins, as solver/schur.py.
        clipd = torch.clamp(dnode, _DIAG_MIN, _DIAG_MAX)
        zero_diag = dnode == 0.0
        scale = torch.where(zero_diag, torch.ones_like(dnode),
                            1.0 / torch.sqrt(clipd))
        vals = gather_rows(torch.cat([scale, lam * clipd * scale * scale,
                                      zero_diag.to(dtype)], dim=1),
                           shard.node_gather)
        vi = vals[:ni].reshape(ni, 3, D) * shard.int_mask[:, None, None]
        s_int = vi[:, 0].reshape(ni * D)
        diag_int = (vi[:, 1] + torch.maximum(
            vi[:, 2], 1.0 - shard.int_mask[:, None])).reshape(ni * D)
        vs = vals[ni:].reshape(ns, 3, D) * shard.sep_live[:, None, None]
        s_sep = vs[:, 0].reshape(ns * D)
        diag_sep = (vs[:, 1] + torch.maximum(
            vs[:, 2], 1.0 - shard.sep_live[:, None])).reshape(ns * D)

        # Per-edge blocks; joint SC subtracts its switch elimination.
        wJa = sys_l.w[:, None, None] * sys_l.Ja
        wJb = sys_l.w[:, None, None] * sys_l.Jb
        Haa = torch.einsum("eki,ekj->eij", wJa, sys_l.Ja)
        Hbb = torch.einsum("eki,ekj->eij", wJb, sys_l.Jb)
        Hab = torch.einsum("eki,ekj->eij", wJa, sys_l.Jb)
        ga = torch.einsum("eki,ek->ei", wJa, sys_l.r)
        gb = torch.einsum("eki,ek->ei", wJb, sys_l.r)
        if is_sc:
            inv_s = 1.0 / (sys_l.Hss + lam * torch.clamp(
                sys_l.Hss, _DIAG_MIN, _DIAG_MAX))
            pa = sys_l.Hps_a * inv_s[:, None]
            Haa = Haa - pa[:, :, None] * sys_l.Hps_a[:, None, :]
            Hbb = Hbb - (sys_l.Hps_b * inv_s[:, None])[:, :, None] \
                * sys_l.Hps_b[:, None, :]
            Hab = Hab - pa[:, :, None] * sys_l.Hps_b[:, None, :]
            gs_inv = (sys_l.gs * inv_s)[:, None]
            ga = ga - gs_inv * sys_l.Hps_a
            gb = gb - gs_inv * sys_l.Hps_b
        rows4 = torch.cat([Haa, Hbb, Hab, Hab.transpose(-1, -2)]).reshape(
            4 * ek, D * D)
        rows2 = torch.cat([ga, gb])
        A, F, b, C, b_s = scatter_add_groups([
            (rows4, shard.plan_A), (rows4, shard.plan_F),
            (rows2, shard.plan_b), (rows4, shard.plan_C),
            (rows2, shard.plan_bs)])
        A = A * s_int[:, None] * s_int[None, :] + torch.diag(diag_int)
        F = F * s_int[:, None] * s_sep[None, :]
        b = -b.reshape(ni * D) * s_int
        C = C * s_sep[:, None] * s_sep[None, :]
        b_s = -b_s.reshape(ns * D) * s_sep

        L, info = torch.linalg.cholesky_ex(A)
        Yb = torch.cholesky_solve(torch.cat([F, b[:, None]], dim=1), L)
        Y, y = Yb[:, :-1], Yb[:, -1]
        # The separator reduction.
        Sr = reduce(torch.cat([(C - F.T @ Y).reshape(-1), b_s - F.T @ y]))
        S = Sr[:(ns * D) ** 2].reshape(ns * D, ns * D) + torch.diag(diag_sep)
        Ls, info_s = torch.linalg.cholesky_ex(S)
        x_sep = torch.cholesky_solve(Sr[(ns * D) ** 2:, None], Ls)[:, 0]
        x_int = nan_unless_factored((y - Y @ x_sep) * s_int, info)
        dx_int, dx_sep = scatter_add_groups([
            (x_int.reshape(ni, D), shard.plan_int),
            ((x_sep * s_sep).reshape(ns, D), shard.plan_sep)])
        dx = nan_unless_factored(dx_sep + reduce(dx_int), info_s)

        new_poses = model.retract(poses, dx)
        if is_sc:
            dxa, dxb = local.gather_ab(dx)
            new_sw = sw - (sys_l.gs + torch.sum(sys_l.Hps_a * dxa, dim=-1)
                           + torch.sum(sys_l.Hps_b * dxb, dim=-1)) * inv_s
        else:
            new_sw = sw
        new_cost = reduce(cost_only(new_poses, new_sw, local,
                                    **kw).reshape(1))[0]
        accept = new_cost < cost_here
        poses = torch.where(accept, new_poses, poses)
        sw = torch.where(accept, new_sw, sw)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=cfg.min_lambda),
                          torch.clamp(lam * nu, max=cfg.max_lambda))
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        cost = torch.where(accept, new_cost, cost_here)
    return poses, cost, cost0, sw


def _prepare(poses0, free, cfg, mesh, model):
    require_type(cfg, SolverConfig, "cfg")
    dtype = getattr(torch, cfg.dtype)
    poses = poses0.to(dtype=dtype, device=mesh.device)
    model = model or model_for_dim(poses.shape[-1])
    return poses, FreeMask(node=free.node.to(dtype=dtype,
                                             device=mesh.device)), model


def distributed_schur_lm(poses0: Tensor, free: FreeMask,
                         prob: DistSchurProblem, cfg: SolverConfig,
                         mesh: Mesh, num_iters: int, model=None):
    """LM with the distributed Schur linear solver over a block mesh of
    ``prob.num_blocks`` ranks; returns ``(poses, cost, cost0, switches
    (P, ek))``, the switches in per-block edge order (all ones unless
    ``cfg.robust == "sc"``)."""
    if mesh.shape[BLOCK_AXIS] != prob.num_blocks:
        raise ValueError(f"{prob.num_blocks} blocks on a mesh of "
                         f"{mesh.shape[BLOCK_AXIS]} ranks")
    poses, free, model = _prepare(poses0, free, cfg, mesh, model)
    shard = shard_problem(prob, mesh.index[BLOCK_AXIS], poses.shape[0],
                          dtype=poses.dtype, device=mesh.device)
    poses, cost, cost0, sw = _schur_lm_shard(poses, shard, free, cfg, mesh,
                                             num_iters, model)
    return poses, cost, cost0, all_gather(sw, mesh, BLOCK_AXIS)


def distributed_batched_schur_lm(poses0: Tensor, free: FreeMask,
                                 prob: DistSchurProblem, cfg: SolverConfig,
                                 mesh: Mesh, num_iters: int, model=None):
    """A batch of distributed Schur LMs over a ``replicas x blocks`` mesh
    (:func:`make_replica_block_mesh
    <slam_tpu_torch.parallel.mesh.make_replica_block_mesh>`): ``prob``
    from :func:`build_dist_problem_batch` and ``poses0 (B, N, pose_dim)``,
    B = the replica count.  Independent outlier seeds across the replica
    axis (no collective in the solve), the separator reductions within
    each replica's block group.  Returns ``(poses, cost, cost0,
    switches)`` with leading batch axes (``switches (B, P, ek)``)."""
    B = poses0.shape[0]
    if mesh.shape[REPLICA_AXIS] != B or prob.int_ids.shape[0] != B:
        raise ValueError(f"replica axis {mesh.shape[REPLICA_AXIS]}, poses "
                         f"batch {B}, problem batch {prob.int_ids.shape[0]}")
    r = mesh.index[REPLICA_AXIS]
    poses, free, model = _prepare(poses0[r], free, cfg, mesh, model)
    mine = prob.replica(r)
    shard = shard_problem(mine, mesh.index[BLOCK_AXIS], poses.shape[0],
                          dtype=poses.dtype, device=mesh.device)
    poses, cost, cost0, sw = _schur_lm_shard(poses, shard, free, cfg, mesh,
                                             num_iters, model)
    sw = all_gather(sw, mesh, BLOCK_AXIS)
    return tuple(all_gather(x, mesh, REPLICA_AXIS)
                 for x in (poses, cost, cost0, sw))


def schur_lm_job(graph: PoseGraph, num_blocks: int, cfg: SolverConfig,
                 num_iters: int, node_block=None,
                 timed: bool = False) -> dict:
    """One rank of :func:`distributed_schur_lm` on ``graph`` (canonical
    order, gauge at node 0), for :func:`launch
    <slam_tpu_torch.parallel.mesh.launch>`: the poses, costs, switches,
    ``(ni, ns, ek)``, the wall and the collectives' calls, bytes and
    seconds (``timed``: the device synchronised around each)."""
    import time

    from slam_tpu_torch import ops
    from slam_tpu_torch.parallel import mesh as pmesh
    from slam_tpu_torch.solver.problem import anchor_first_node

    t_job = time.perf_counter()
    mesh = pmesh.make_block_mesh(num_blocks)
    g = graph.canonical_order()
    prob = build_dist_problem(g, num_blocks, node_block=node_block)
    dtype = getattr(torch, cfg.dtype)
    free = anchor_first_node(g.num_nodes, dtype=dtype, device=mesh.device)
    poses0 = torch.as_tensor(g.poses, dtype=dtype, device=mesh.device)
    ops.reset_launches()
    pmesh.reset_collectives(timed)
    t0 = time.perf_counter()
    poses, cost, cost0, sw = distributed_schur_lm(poses0, free, prob, cfg,
                                                  mesh, num_iters)
    cost_f = float(cost)  # synchronises
    wall = time.perf_counter() - t0
    setup = t0 - t_job
    return dict(poses=poses, cost=cost_f, cost0=float(cost0), switches=sw,
                ni=prob.ni, ns=prob.ns, ek=prob.ek, wall_s=wall,
                setup_s=setup, backend=torch.distributed.get_backend(),
                launches=ops.launch_counts(),
                **{k: v for k, v in pmesh.COLLECTIVES.items()
                   if k != "timed"})


def batched_schur_lm_job(graphs, num_blocks: int, cfg: SolverConfig,
                         num_iters: int) -> dict:
    """One rank of :func:`distributed_batched_schur_lm` on ``graphs`` (one
    per replica, same node count), for :func:`launch
    <slam_tpu_torch.parallel.mesh.launch>`."""
    from slam_tpu_torch.parallel import mesh as pmesh
    from slam_tpu_torch.solver.problem import anchor_first_node

    mesh = pmesh.make_replica_block_mesh(len(graphs), num_blocks)
    gs = [g.canonical_order() for g in graphs]
    prob = build_dist_problem_batch(gs, num_blocks)
    dtype = getattr(torch, cfg.dtype)
    free = anchor_first_node(gs[0].num_nodes, dtype=dtype,
                             device=mesh.device)
    poses0 = torch.as_tensor(np.stack([g.poses for g in gs]), dtype=dtype,
                             device=mesh.device)
    poses, cost, cost0, sw = distributed_batched_schur_lm(
        poses0, free, prob, cfg, mesh, num_iters)
    return dict(poses=poses, cost=cost, cost0=cost0, switches=sw)


def replica_rows_job(graphs, num_blocks: int, cfg: SolverConfig,
                     num_iters: int) -> dict:
    """Each replica row of a ``len(graphs) x num_blocks`` mesh solves its
    own graph alone: :func:`distributed_schur_lm` on the graph's own
    (unpadded) problem over the row's block group.  The results are
    gathered over the replica axis, for :func:`launch
    <slam_tpu_torch.parallel.mesh.launch>` (the per-seed comparison of
    :func:`batched_schur_lm_job` in the same launch)."""
    from slam_tpu_torch.parallel import mesh as pmesh
    from slam_tpu_torch.solver.problem import anchor_first_node

    mesh = pmesh.make_replica_block_mesh(len(graphs), num_blocks)
    k = mesh.index[BLOCK_AXIS]
    row = Mesh(axes=(BLOCK_AXIS,), shape={BLOCK_AXIS: num_blocks},
               index={BLOCK_AXIS: k},
               groups={BLOCK_AXIS: mesh.groups[BLOCK_AXIS]}, rank=k,
               world_size=num_blocks, device=mesh.device)
    g = graphs[mesh.index[REPLICA_AXIS]].canonical_order()
    dtype = getattr(torch, cfg.dtype)
    free = anchor_first_node(g.num_nodes, dtype=dtype, device=mesh.device)
    poses0 = torch.as_tensor(g.poses, dtype=dtype, device=mesh.device)
    out = distributed_schur_lm(poses0, free,
                               build_dist_problem(g, num_blocks), cfg, row,
                               num_iters)
    poses, cost, cost0 = (all_gather(x, mesh, REPLICA_AXIS)
                          for x in out[:3])
    return dict(poses=poses, cost=cost, cost0=cost0)
