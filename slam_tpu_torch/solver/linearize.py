"""Batched residual evaluation and normal-equation assembly.

Port of ``slam_tpu/solver/linearize.py``.  On SE(2), robust modes
none/dcs (methods 0/1) run the per-edge chain as the fused
``linearize_se2`` kernel (``ops/linearize.py``), which reads the edge
endpoints itself; sc/sc_varpro, and every mode on SE(3), run the plain
chain below, after one ``gather_rows`` launch per source.
The node sums of a call are one ``scatter_add_rows`` launch.

``seeds=B`` reads the edges as B seeds' problems, each a contiguous block
of ``E / B`` edges (``solver/batch.py``), and returns each seed's cost,
``(B,)``; the per-edge and per-node arithmetic is the same (the plain
chain's block products one problem at a time, :func:`_each`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_tpu_torch.ops.linearize import fused_linearize_se2_indexed
from slam_tpu_torch.robust import kernels
from slam_tpu_torch.solver.problem import EdgeSet, FreeMask

Tensor = torch.Tensor


class BlockSystem(NamedTuple):
    """Block-sparse Gauss-Newton system ``H dx = -g`` plus the current cost
    (field meanings as in ``slam_tpu/solver/linearize.py``)."""

    Hdiag: Tensor   # (N, D, D) node-diagonal blocks
    Hoff: Tensor    # (E, D, D) off-diagonal block of edge e at (a_e, b_e)
    g: Tensor       # (N, D) gradient J^T W r
    cost: Tensor    # 0.5 * sum rho(|r|^2): scalar, or (B,) per seed
    Ja: Tensor      # (E, R, D) robust-scaled, gauged Jacobian wrt a
    Jb: Tensor      # (E, R, D)
    r: Tensor       # (E, R) robust-scaled residual
    w: Tensor       # (E,) Huber IRLS weight * active
    Js: Tensor      # (E, R) residual Jacobian wrt the switch variable
    Hps_a: Tensor   # (E, D) coupling H[pose_a, s_e]
    Hps_b: Tensor   # (E, D)
    Hss: Tensor     # (E,) switch diagonal
    gs: Tensor      # (E,) switch gradient


def _total(x: Tensor, seeds: int | None) -> Tensor:
    """The sum of ``x``, or with ``seeds`` each seed's: ``(seeds,)`` sums
    of contiguous blocks."""
    if seeds is None:
        return torch.sum(x)
    return torch.sum(x.reshape(seeds, -1), dim=-1)


def _fixed_identity(free: FreeMask, D: int, scale: float) -> Tensor:
    eye = torch.eye(D, dtype=free.node.dtype, device=free.node.device)
    return scale * (1.0 - free.node)[:, None, None] * eye


def _each(seeds: int | None, spec: str, *xs: Tensor) -> Tensor:
    """``torch.einsum(spec, *xs)`` over the edges, or for ``seeds``
    problems one call on each problem's edges, concatenated: on the card
    the batched product's kernel depends on its batch count, so each
    problem's products are then its own alone's to the bit."""
    if seeds is None:
        return torch.einsum(spec, *xs)
    n = xs[0].shape[0] // seeds
    return torch.cat([torch.einsum(spec, *(x[k * n:(k + 1) * n]
                                           for x in xs))
                      for k in range(seeds)])


def linearize(
    poses: Tensor,
    switches: Tensor,
    edges: EdgeSet,
    free: FreeMask,
    *,
    model,
    robust: str,
    dcs_phi: float,
    huber_delta: float,
    sc_prior_lambda: float,
    fixed_identity_scale: float = 1.0,
    seeds: int | None = None,
) -> BlockSystem:
    """Linearise the robust pose-graph objective at ``poses``; with
    ``seeds``, ``cost`` holds each seed's."""
    if poses.shape[0] != edges.num_nodes:
        raise ValueError(f"EdgeSet plans cover {edges.num_nodes} nodes, "
                         f"got {poses.shape[0]} poses")
    if robust in ("none", "dcs") and model.pose_dim == 3:
        return _linearize_fused(poses, edges, free, model=model,
                                robust=robust, dcs_phi=dcs_phi,
                                huber_delta=huber_delta,
                                fixed_identity_scale=fixed_identity_scale,
                                seeds=seeds)

    pa, pb = edges.gather_ab(poses)
    fa, fb = edges.gather_ab(free.node)
    e, Ja, Jb = model.residual_and_jacobians(pa, pb, edges.meas)
    Ja = Ja * fa[:, None, None]
    Jb = Jb * fb[:, None, None]
    loop_f = edges.loop_f.to(poses.dtype)
    m = loop_f[:, None]
    mm = loop_f[:, None, None]
    Js = torch.zeros_like(e)
    if robust == "dcs":
        es, Jas, Jbs = kernels.dcs_scale(e, Ja, Jb, dcs_phi,
                                         dims=model.dcs_dims)
    elif robust == "sc":
        es, Jas, Jbs, Jss = kernels.switch_scale(e, Ja, Jb, switches)
        Js = m * Jss
    elif robust == "sc_varpro":
        es, Jas, Jbs = kernels.sc_varpro_scale(e, Ja, Jb, sc_prior_lambda)
    elif robust != "none":
        raise ValueError(f"unknown robust mode {robust!r}")
    if robust != "none":
        e = m * es + (1 - m) * e
        Ja = mm * Jas + (1 - mm) * Ja
        Jb = mm * Jbs + (1 - mm) * Jb

    s2 = torch.sum(e * e, dim=-1)
    w = kernels.huber_weight(s2, huber_delta) * edges.active
    cost = 0.5 * _total(edges.active * kernels.huber_rho(s2, huber_delta),
                        seeds)
    wj = w[:, None, None]
    Haa = wj * _each(seeds, "eki,ekj->eij", Ja, Ja)
    Hbb = wj * _each(seeds, "eki,ekj->eij", Jb, Jb)
    Hoff = wj * _each(seeds, "eki,ekj->eij", Ja, Jb)
    ga = w[:, None] * _each(seeds, "eki,ek->ei", Ja, e)
    gb = w[:, None] * _each(seeds, "eki,ek->ei", Jb, e)
    Hdiag, g = edges.node_sums((Haa, Hbb), (ga, gb))
    Hdiag = Hdiag + _fixed_identity(free, model.tangent_dim,
                                    fixed_identity_scale)

    if robust == "sc":
        live = edges.active * loop_f
        Hps_a = w[:, None] * _each(seeds, "eki,ek->ei", Ja, Js)
        Hps_b = w[:, None] * _each(seeds, "eki,ek->ei", Jb, Js)
        Hss_meas = w * torch.sum(Js * Js, dim=-1)
        gs_meas = w * torch.sum(Js * e, dim=-1)
        lam = sc_prior_lambda
        prior_r = kernels.switch_prior_residual(switches, lam)
        cost = cost + 0.5 * _total(live * prior_r * prior_r, seeds)
        Hss = live * (Hss_meas + lam) + (1.0 - live)
        gs = live * (gs_meas - math.sqrt(lam) * prior_r)
        Hps_a = live[:, None] * Hps_a
        Hps_b = live[:, None] * Hps_b
        return BlockSystem(Hdiag=Hdiag, Hoff=Hoff, g=g, cost=cost, Ja=Ja,
                           Jb=Jb, r=e, w=w, Js=Js, Hps_a=Hps_a, Hps_b=Hps_b,
                           Hss=Hss, gs=gs)
    return BlockSystem(Hdiag=Hdiag, Hoff=Hoff, g=g, cost=cost, Ja=Ja, Jb=Jb,
                       r=e, w=w, Js=Js,
                       **_neutral_switches(edges.num_edges, model, poses))


def _neutral_switches(E: int, model, like: Tensor) -> dict:
    D = model.tangent_dim
    kw = dict(dtype=like.dtype, device=like.device)
    return dict(Hps_a=torch.zeros((E, D), **kw),
                Hps_b=torch.zeros((E, D), **kw),
                Hss=torch.ones((E,), **kw), gs=torch.zeros((E,), **kw))


def _linearize_fused(poses, edges, free, *, model, robust, dcs_phi,
                     huber_delta, fixed_identity_scale, seeds) -> BlockSystem:
    """The per-edge chain as one launch of the fused kernel on the poses
    and the edge endpoints, node sums through one ``scatter_add_rows``
    launch."""
    out = fused_linearize_se2_indexed(poses, free.node, edges, dcs_phi,
                                      huber_delta, robust=robust)
    Hdiag, g = edges.node_sums((out["Haa"], out["Hbb"]),
                               (out["ga"], out["gb"]))
    Hdiag = Hdiag + _fixed_identity(free, model.tangent_dim,
                                    fixed_identity_scale)
    E = edges.num_edges
    return BlockSystem(
        Hdiag=Hdiag, Hoff=out["Hoff"], g=g,
        cost=0.5 * _total(out["rho"], seeds),
        Ja=out["Ja"], Jb=out["Jb"], r=out["e"], w=out["w"],
        Js=torch.zeros((E, model.residual_dim), dtype=poses.dtype,
                       device=poses.device),
        **_neutral_switches(E, model, poses))


def cost_only(
    poses: Tensor,
    switches: Tensor,
    edges: EdgeSet,
    *,
    model,
    robust: str,
    dcs_phi: float,
    huber_delta: float,
    sc_prior_lambda: float,
    seeds: int | None = None,
) -> Tensor:
    """Objective value only (for LM step accept/reject); with ``seeds``,
    each seed's."""
    e = model.residual(*edges.gather_ab(poses), edges.meas)
    loop_f = edges.loop_f.to(poses.dtype)
    if robust == "dcs":
        psi = kernels.dcs_psi(e, dcs_phi, dims=model.dcs_dims)
        e = (loop_f * psi + (1 - loop_f))[:, None] * e
    elif robust == "sc":
        e = (loop_f * switches + (1 - loop_f))[:, None] * e
    elif robust == "sc_varpro":
        psi = kernels.sc_varpro_switch(e, sc_prior_lambda)
        e = (loop_f * psi + (1 - loop_f))[:, None] * e
    s2 = torch.sum(e * e, dim=-1)
    cost = 0.5 * _total(edges.active * kernels.huber_rho(s2, huber_delta),
                        seeds)
    if robust == "sc":
        live = edges.active * loop_f
        pr = kernels.switch_prior_residual(switches, sc_prior_lambda)
        cost = cost + 0.5 * _total(live * pr * pr, seeds)
    return cost


def loop_psi(poses: Tensor, edges: EdgeSet, model, phi: float) -> Tensor:
    """Per-edge DCS psi at ``poses`` from the raw xy residual."""
    e = model.residual(*edges.gather_ab(poses), edges.meas)
    return kernels.dcs_psi(e, phi, dims=model.dcs_dims)


def loop_psi_mean(poses: Tensor, edges: EdgeSet, model, phi: float) -> Tensor:
    """Mean DCS psi over live loop edges at ``poses``."""
    psi = loop_psi(poses, edges, model, phi)
    live = edges.active * edges.loop_f.to(poses.dtype)
    return torch.sum(live * psi) / torch.clamp(torch.sum(live), min=1.0)


def edge_residuals(poses: Tensor, edges: EdgeSet, model=None) -> Tensor:
    """Raw (unscaled) residuals of every edge at ``poses`` -- the layering
    methods' residual feedback (``layer_manager.cpp:181-228``).
    ``model=None`` takes SE(2), as the JAX package does."""
    from slam_tpu_torch.solver.models import SE2Model

    return (model or SE2Model).residual(*edges.gather_ab(poses), edges.meas)


def edge_mahalanobis(poses: Tensor, edges: EdgeSet) -> Tensor:
    """Per-edge Mahalanobis distance ``sqrt(r^T Omega r)`` of the SE(2)
    residual, from the 6 upper-triangle information entries (method 4's
    outlier gate, ``simple_layer_manager.cpp:388-442``)."""
    r = edge_residuals(poses, edges)
    i = edges.info
    q = (i[:, 0] * r[:, 0] ** 2
         + i[:, 3] * r[:, 1] ** 2
         + i[:, 5] * r[:, 2] ** 2
         + 2.0 * i[:, 1] * r[:, 0] * r[:, 1]
         + 2.0 * i[:, 2] * r[:, 0] * r[:, 2]
         + 2.0 * i[:, 4] * r[:, 1] * r[:, 2])
    return torch.sqrt(torch.clamp(q, min=0.0))


def edge_info_gain(edges: EdgeSet) -> Tensor:
    """D-opt proxy ``0.5 * logdet(I + Omega)`` per SE(2) edge
    (``layer_manager.cpp:284-298``)."""
    i = edges.info
    O = torch.stack([
        torch.stack([i[:, 0], i[:, 1], i[:, 2]], -1),
        torch.stack([i[:, 1], i[:, 3], i[:, 4]], -1),
        torch.stack([i[:, 2], i[:, 4], i[:, 5]], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=i.dtype, device=i.device)
    _, logdet = torch.linalg.slogdet(eye + O)
    return 0.5 * logdet
