"""Edge-data-parallel LM on ``torch.distributed``: sharded linearisation
and a collective block-Jacobi PCG.

Port of ``slam_tpu/parallel/distributed.py``:

* **Edges are the data axis.**  Each rank holds a contiguous shard of the
  padded edge set, with its own scatter plans over all N nodes, and
  linearises it: the fused ``linearize_se2`` kernel for SE(2) none/DCS,
  the plain chain for joint SC and SE(3), node sums through one
  ``scatter_add_rows`` launch.  One ``all_reduce`` then sums the partial
  node systems and the cost.  Joint SC eliminates each shard's switches
  from its partial system before the reduction: every switch belongs to
  one edge, hence to one rank, so the summed corrections are the global
  ones.
* **PCG runs with x replicated.**  Every CG iteration makes one
  ``all_reduce`` of the off-diagonal action, a ``gather_rows`` and a
  grouped ``scatter_add_rows`` launch on the local shard; the
  node-diagonal action, the preconditioner and the CG scalars are
  computed redundantly on every rank.

Every decision (the CG stop, accept/reject, lambda) is taken from
all-reduced values, so every rank takes the same branch and makes the
same collectives; the ranks end with the same poses to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.config import SolverConfig
from slam_tpu_torch.parallel.mesh import EDGE_AXIS, Mesh, all_gather, \
    all_reduce, pad_to_multiple
from slam_tpu_torch.runtime import require_type
from slam_tpu_torch.solver import linear
from slam_tpu_torch.solver.linear import CHECK_EVERY, _bmv, _inv_blocks
from slam_tpu_torch.solver.linearize import cost_only, linearize
from slam_tpu_torch.solver.models import model_for_dim
from slam_tpu_torch.solver.problem import EdgeSet, FreeMask, \
    edge_set_from_arrays

Tensor = torch.Tensor


def _host(edges: EdgeSet) -> dict:
    return dict(ij=edges.ij.cpu().numpy(), meas=edges.meas.cpu().numpy(),
                is_loop=edges.is_loop.cpu().numpy(),
                active=edges.active.cpu().numpy(),
                info=edges.info.cpu().numpy())


def pad_edges_for_mesh(edges: EdgeSet, num_ranks: int) -> EdgeSet:
    """Pad the edge set to a multiple of the rank count with inactive
    (0, 0) edges (an SE(3) pad holds the identity quaternion)."""
    E = edges.num_edges
    pad = pad_to_multiple(E, num_ranks) - E
    if pad == 0:
        return edges
    h = _host(edges)

    def pz(x):
        return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])

    out = {k: pz(v) for k, v in h.items()}
    if out["meas"].shape[1] == 7:
        out["meas"][E:, 3] = 1.0
    return edge_set_from_arrays(num_nodes=edges.num_nodes,
                                dtype=edges.meas.dtype,
                                device=edges.ij.device, **out)


def shard_edges(edges: EdgeSet, mesh: Mesh,
                axis: str = EDGE_AXIS) -> EdgeSet:
    """This rank's contiguous shard of the padded edge set, with its own
    scatter plans (over all nodes) on the mesh's device."""
    n, E = mesh.shape[axis], edges.num_edges
    if E % n:
        raise ValueError(f"{E} edges do not split over {n} ranks "
                         "(pad_edges_for_mesh)")
    k, m = mesh.index[axis], E // n
    h = {key: v[k * m:(k + 1) * m] for key, v in _host(edges).items()}
    return edge_set_from_arrays(num_nodes=edges.num_nodes,
                                dtype=edges.meas.dtype, device=mesh.device,
                                **h)


def distributed_lm(poses0: Tensor, edges: EdgeSet, free: FreeMask,
                   cfg: SolverConfig, mesh: Mesh, num_iters: int,
                   model=None, axis: str = EDGE_AXIS):
    """``num_iters`` LM iterations of this rank's edge shard ``edges``
    (:func:`shard_edges`) with collective block-Jacobi PCG, whatever the
    configured linear solver.  Returns ``(poses, final_cost,
    initial_cost, switches)``, ``switches`` in padded global edge order
    (all ones unless ``cfg.robust == "sc"``)."""
    require_type(cfg, SolverConfig, "cfg")
    model = model or model_for_dim(poses0.shape[-1])
    dtype = getattr(torch, cfg.dtype)
    dev = edges.ij.device
    poses = poses0.to(dtype=dtype, device=dev)
    free = FreeMask(node=free.node.to(dtype=dtype, device=dev))
    nd = mesh.shape[axis]
    n = poses.shape[0]
    kw = dict(model=model, robust=cfg.robust, dcs_phi=cfg.dcs_phi,
              huber_delta=cfg.huber_delta,
              sc_prior_lambda=cfg.sc_prior_lambda)
    is_sc = cfg.robust == "sc"

    def reduce(t):
        return all_reduce(t.contiguous(), mesh, axis)

    sw = torch.ones_like(edges.active)
    cost = reduce(cost_only(poses, sw, edges, **kw).reshape(1))[0]
    cost0 = cost
    lam = torch.full((), cfg.init_lambda, dtype=dtype, device=dev)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    for _ in range(num_iters):
        sys_l = linearize(poses, sw, edges, free,
                          fixed_identity_scale=1.0 / nd, **kw)
        if is_sc:
            sys_l, backsub = linear.eliminate_switches(sys_l, edges, lam)
        D = sys_l.Hdiag.shape[-1]
        # The separator reduction: partial node systems and cost in one.
        red = reduce(torch.cat([sys_l.Hdiag.reshape(-1), sys_l.g.reshape(-1),
                                sys_l.cost.reshape(1)]))
        Hdiag = red[:n * D * D].reshape(n, D, D)
        g = red[n * D * D:-1].reshape(n, D)
        cost_here = red[-1]

        d = torch.diagonal(Hdiag, dim1=-2, dim2=-1)
        damp = lam * torch.clamp(d, linear._DIAG_MIN, linear._DIAG_MAX)
        Hd = Hdiag + torch.diag_embed(damp)
        Minv = _inv_blocks(Hd)
        Hoff, HoffT = sys_l.Hoff, sys_l.Hoff.transpose(-1, -2)

        def matvec(x):
            xa, xb = edges.gather_ab(x)
            Sa, Sb = edges.endpoint_sums((_bmv(Hoff, xb), _bmv(HoffT, xa)))
            return _bmv(Hd, x) + reduce(Sa + Sb)

        dx = _block_jacobi_pcg(matvec, Minv, -g, cfg)
        new_poses = model.retract(poses, dx)
        new_sw = sw + backsub(dx) if is_sc else sw
        new_cost = reduce(cost_only(new_poses, new_sw, edges,
                                    **kw).reshape(1))[0]
        accept = new_cost < cost_here
        poses = torch.where(accept, new_poses, poses)
        sw = torch.where(accept, new_sw, sw)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=cfg.min_lambda),
                          torch.clamp(lam * nu, max=cfg.max_lambda))
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        cost = torch.where(accept, new_cost, cost_here)
    return poses, cost, cost0, all_gather(sw, mesh, axis).reshape(-1)


def _block_jacobi_pcg(matvec, Minv: Tensor, b: Tensor,
                      cfg: SolverConfig) -> Tensor:
    """The JAX package's CG ``while_loop`` (``k < max_iters`` and ``r.r >
    rtol^2 b.b`` tested before each iteration) as a loop whose test stays
    on the device: once it fails a flag freezes the iterates, and the
    host reads the flag every ``CHECK_EVERY`` iterations.  Every rank
    reads the same flag at the same iteration, so the collectives of the
    matvec stay in step."""
    x = torch.zeros_like(b)
    r = b
    z = _bmv(Minv, r)
    p = z
    rz = torch.sum(r * z)
    tol2 = cfg.pcg_rtol ** 2 * torch.sum(b * b)
    running = torch.sum(r * r) > tol2
    for k in range(cfg.pcg_max_iters):
        if k % CHECK_EVERY == 0 and not bool(running):
            break
        Ap = matvec(p)
        alpha = rz / (torch.sum(p * Ap) + 1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = _bmv(Minv, r_new)
        rz_new = torch.sum(r_new * z)
        p_new = z + (rz_new / (rz + 1e-30)) * p
        x = torch.where(running, x_new, x)
        r = torch.where(running, r_new, r)
        p = torch.where(running, p_new, p)
        rz = torch.where(running, rz_new, rz)
        running = running & (torch.sum(r * r) > tol2)
    return x


def edge_lm_job(graph, cfg: SolverConfig, num_iters: int,
                timed: bool = False) -> dict:
    """One rank of :func:`distributed_lm` on ``graph`` (canonical order,
    padded to the rank count, gauge at node 0), for :func:`launch
    <slam_tpu_torch.parallel.mesh.launch>`: the poses, costs and
    switches, with the collectives' calls, bytes and seconds."""
    import time

    from slam_tpu_torch import ops
    from slam_tpu_torch.parallel import mesh as pmesh
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph

    t_job = time.perf_counter()
    mesh = pmesh.make_edge_mesh()
    dtype = getattr(torch, cfg.dtype)
    g = graph.canonical_order()
    edges = pad_edges_for_mesh(edge_set_from_graph(g, dtype=dtype),
                               mesh.world_size)
    local = shard_edges(edges, mesh)
    free = anchor_first_node(g.num_nodes, dtype=dtype, device=mesh.device)
    poses0 = torch.as_tensor(g.poses, dtype=dtype, device=mesh.device)
    model = model_for_dim(g.dim)
    ops.reset_launches()
    pmesh.reset_collectives(timed)
    t0 = time.perf_counter()
    poses, cost, cost0, sw = distributed_lm(poses0, local, free, cfg, mesh,
                                            num_iters, model=model)
    cost_f = float(cost)  # synchronises
    wall = time.perf_counter() - t0
    setup = t0 - t_job
    return dict(poses=poses, cost=cost_f, cost0=float(cost0), switches=sw,
                wall_s=wall, setup_s=setup,
                backend=torch.distributed.get_backend(),
                launches=ops.launch_counts(),
                **{k: v for k, v in pmesh.COLLECTIVES.items()
                   if k != "timed"})
