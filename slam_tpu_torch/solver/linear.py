"""Linear solves of the damped normal equations ``(H + lam D) dx = -g``.

Port of ``slam_tpu/solver/linear.py`` (its CPU paths; the one-hot
incidence operators were a TPU workaround).  Vectors over the unknowns are
a pair ``(poses (N, D), switches (E,))``; the switches are unknowns of
method 2's joint system (``robust="sc"``) and solve to 0 otherwise.

- ``dense_solve``: the system is assembled into a dense matrix by one
  ``scatter_add_rows`` launch over a block grid (the plan is built once
  per graph by :func:`dense_plan`), Jacobi-equilibrated and
  Cholesky-factored.  With the switches it is the joint system: one
  unknown per edge after the node-major pose unknowns.
- ``eliminate_switches``: the exact elimination of the diagonal switch
  block, so that method 2 rides the pose-only Schur solver; its per-node
  corrections are one grouped ``scatter_add_rows`` launch.
- ``pcg_solve``: preconditioned conjugate gradients on the joint system;
  each matvec is one ``gather_rows`` and one grouped ``scatter_add_rows``
  launch, and the stopping test is read on the host only every
  :data:`CHECK_EVERY` iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.ops.gather import SegmentPlan, scatter_add_rows, \
    segment_plan
from slam_tpu_torch.solver.linearize import BlockSystem
from slam_tpu_torch.solver.problem import EdgeSet

Tensor = torch.Tensor

# Ceres clamps the LM diagonal to [1e-6, 1e32].
_DIAG_MIN = 1e-6
_DIAG_MAX = 1e32
#: CG iterations between two host reads of the stopping test.
CHECK_EVERY = 8


class Update(NamedTuple):
    poses: Tensor     # (N, D) tangent-space pose updates
    switches: Tensor  # (E,)


def damped_diag(system: BlockSystem, lam: Tensor) -> tuple[Tensor, Tensor]:
    """LM-damped diagonal blocks ``Hdiag + lam * clip(diag(Hdiag))`` and the
    damped switch diagonal."""
    d = torch.diagonal(system.Hdiag, dim1=-2, dim2=-1)
    damp = lam * torch.clamp(d, _DIAG_MIN, _DIAG_MAX)
    Hd = system.Hdiag + torch.diag_embed(damp)
    Hss = system.Hss + lam * torch.clamp(system.Hss, _DIAG_MIN, _DIAG_MAX)
    return Hd, Hss


def nan_unless_factored(x: Tensor, info: Tensor) -> Tensor:
    """NaN where a Cholesky failed, as JAX's ``cho_factor`` reports it, so
    the LM loop rejects the step; checked without a host sync."""
    return torch.where(torch.all(info == 0), x, torch.full_like(x, np.nan))


# ---------------------------------------------------------------------------
# Dense solve
# ---------------------------------------------------------------------------

class JointPlan(NamedTuple):
    """Dense assembly of the joint pose-and-switch system: ``plan`` places
    D x D blocks in an ``(n + m) x (n + m)`` block grid, ``m = ceil(E/D)``;
    switch ``e`` is unknown ``D*n + e``, row ``e % D`` (``row_sel``, a
    one-hot (E, D)) of block row ``n + e // D``."""

    plan: SegmentPlan
    row_sel: Tensor


def dense_plan(edges: EdgeSet, switches: bool = False):
    """Scatter plan of ``[Hd (n), Hoff (E), Hoff^T (E)]`` blocks into the
    ``n x n`` grid of D x D blocks (segment ``row * n + col``) of the
    ``(n*D, n*D)`` matrix; with ``switches`` a :class:`JointPlan` that
    also places, per edge, its switch diagonal and its couplings to both
    endpoints (a self-loop's two couplings add)."""
    n, E, D = edges.num_nodes, edges.num_edges, edges.tangent_dim
    ij = edges.ij.cpu().numpy().astype(np.int64)
    a, b = ij[:, 0], ij[:, 1]
    nodes = np.arange(n)
    dev = edges.ij.device
    if not switches:
        idx = np.concatenate([nodes * n + nodes, a * n + b, b * n + a])
        return segment_plan(idx, n * n, device=dev, grid=((), n, n))
    w = n + -(-E // D)
    s = n + np.arange(E) // D   # block row of each switch
    idx = np.concatenate([nodes * w + nodes, a * w + b, b * w + a,
                          s * w + s, s * w + a, a * w + s, s * w + b,
                          b * w + s])
    row_sel = torch.eye(D, dtype=edges.meas.dtype,
                        device=dev)[torch.arange(E, device=dev) % D]
    return JointPlan(segment_plan(idx, w * w, device=dev, grid=((), w, w)),
                     row_sel)


def _finish_dense(H: Tensor, rhs: Tensor, n: int, D: int, E: int,
                  switches: bool) -> Update:
    # Jacobi equilibration improves f32 conditioning markedly.
    dscale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H * dscale[:, None] * dscale[None, :]
    L, info = torch.linalg.cholesky_ex(Hs)
    sol = torch.cholesky_solve((rhs * dscale)[:, None], L)[:, 0] * dscale
    sol = nan_unless_factored(sol, info)
    ds = sol[D * n:] if switches else torch.zeros(
        (E,), dtype=sol.dtype, device=sol.device)
    return Update(poses=sol[:D * n].reshape(n, D), switches=ds)


def dense_solve(system: BlockSystem, edges: EdgeSet, lam: Tensor,
                plan) -> Update:
    """Exact damped solve through the dense Jacobi-equilibrated Cholesky:
    pose unknowns under a :class:`SegmentPlan`, the joint system with one
    switch unknown per edge under a :class:`JointPlan`."""
    n, D = system.Hdiag.shape[0], system.Hdiag.shape[-1]
    E = edges.num_edges
    Hd, Hss = damped_diag(system, lam)
    rows = [Hd, system.Hoff, system.Hoff.transpose(-1, -2)]
    rhs = -system.g.reshape(-1)
    switches = isinstance(plan, JointPlan)
    if switches:
        sel = plan.row_sel
        Sa = sel[:, :, None] * system.Hps_a[:, None, :]
        Sb = sel[:, :, None] * system.Hps_b[:, None, :]
        rows += [Hss[:, None, None] * (sel[:, :, None] * sel[:, None, :]),
                 Sa, Sa.transpose(-1, -2), Sb, Sb.transpose(-1, -2)]
        rhs = torch.cat([rhs, -system.gs])
        plan = plan.plan
    H = scatter_add_rows(torch.cat(rows).reshape(-1, D * D), plan)
    dim = rhs.shape[0]
    return _finish_dense(H[:dim, :dim], rhs, n, D, E, switches)


# ---------------------------------------------------------------------------
# Switch elimination (method 2 on the pose-only solvers)
# ---------------------------------------------------------------------------

def eliminate_switches(system: BlockSystem, edges: EdgeSet, lam: Tensor):
    """Exactly eliminate the switch unknowns from the damped joint system.

    ``Hss`` is diagonal, so the Schur complement onto the poses is a
    closed-form per-edge correction of ``Hdiag[a]``, ``Hdiag[b]``,
    ``Hoff[e]`` and ``g[a]``, ``g[b]``, with the damped switch diagonal
    (see the JAX package for why that damping is legitimate).  Returns
    ``(reduced_system, backsub)``; ``backsub(xp)`` gives the switch
    updates of the pose update ``xp`` through one ``gather_rows`` launch.
    """
    E, n, D = system.Hss.shape[0], system.Hdiag.shape[0], \
        system.Hdiag.shape[-1]
    Hss_d = system.Hss + lam * torch.clamp(system.Hss, _DIAG_MIN, _DIAG_MAX)
    inv = 1.0 / Hss_d
    gs_inv = system.gs * inv
    Hps_a, Hps_b = system.Hps_a, system.Hps_b
    ca = -(Hps_a[:, :, None] * Hps_a[:, None, :]) * inv[:, None, None]
    cb = -(Hps_b[:, :, None] * Hps_b[:, None, :]) * inv[:, None, None]
    Sca, Scb, Sga, Sgb = edges.endpoint_sums(
        (ca.reshape(E, D * D), cb.reshape(E, D * D)),
        (Hps_a * gs_inv[:, None], Hps_b * gs_inv[:, None]))
    reduced = system._replace(
        Hdiag=system.Hdiag + Sca.reshape(n, D, D) + Scb.reshape(n, D, D),
        Hoff=system.Hoff - (Hps_a[:, :, None] * Hps_b[:, None, :])
        * inv[:, None, None],
        g=system.g - Sga - Sgb,
        Hps_a=torch.zeros_like(Hps_a), Hps_b=torch.zeros_like(Hps_b),
        Hss=torch.ones_like(system.Hss), gs=torch.zeros_like(system.gs))

    def backsub(xp: Tensor) -> Tensor:
        xa, xb = edges.gather_ab(xp)
        return -(system.gs + torch.sum(Hps_a * xa, dim=-1)
                 + torch.sum(Hps_b * xb, dim=-1)) * inv

    return reduced, backsub


# ---------------------------------------------------------------------------
# Preconditioned conjugate gradients
# ---------------------------------------------------------------------------

def _bmv(m: Tensor, v: Tensor) -> Tensor:
    """``m[i] @ v[i]`` for ``m (N, D, D)``, ``v (N, D)``."""
    return (m @ v[:, :, None])[:, :, 0]


def matvec(system: BlockSystem, edges: EdgeSet, Hd: Tensor, Hss: Tensor,
           x: Update) -> Update:
    """``y = (H + lam D) x`` from the block-sparse pieces: for each edge
    ``e = (a, b)``, ``y[a] += Hoff_e x[b] + Hps_a,e x_s,e`` and ``y[b] +=
    Hoff_e^T x[a] + Hps_b,e x_s,e``; one gather of both endpoints and one
    scatter launch of the four sums, added in the JAX package's order."""
    xp, xs = x
    xa, xb = edges.gather_ab(xp)
    Sa, Sb, Sqa, Sqb = edges.endpoint_sums(
        (_bmv(system.Hoff, xb), _bmv(system.Hoff.transpose(-1, -2), xa)),
        (system.Hps_a * xs[:, None], system.Hps_b * xs[:, None]))
    y = _bmv(Hd, xp) + Sa + Sb + Sqa + Sqb
    ys = Hss * xs + torch.sum(system.Hps_a * xa, dim=-1) \
        + torch.sum(system.Hps_b * xb, dim=-1)
    return Update(poses=y, switches=ys)


def _inv_blocks(m: Tensor) -> Tensor:
    """Batched small-block inverse: the closed-form adjugate for 3x3,
    ``torch.linalg.inv`` for other widths."""
    if m.shape[-1] != 3:
        return torch.linalg.inv(m)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d  # noqa: E741
    inv_det = 1.0 / (a * A + b * B + c * C)
    adj = torch.stack([torch.stack([A, D, G], -1),
                       torch.stack([B, E, H], -1),
                       torch.stack([C, F, I], -1)], dim=-2)
    return adj * inv_det[..., None, None]


def _dot(x: Update, y: Update) -> Tensor:
    return torch.sum(x.poses * y.poses) + torch.sum(x.switches * y.switches)


def _where(flag: Tensor, new: Update, old: Update) -> Update:
    return Update(torch.where(flag, new.poses, old.poses),
                  torch.where(flag, new.switches, old.switches))


def pcg_solve(system: BlockSystem, edges: EdgeSet, lam: Tensor,
              max_iters: int = 250, rtol: float = 1e-8,
              preconditioner: str = "tridiag") -> tuple[Update, int]:
    """Preconditioned CG on the damped joint normal equations.

    ``preconditioner``: "tridiag" (the block-tridiagonal odometry chain
    solved by cyclic reduction, ``solver/tridiag.py``) or "jacobi" (the
    inverted node-diagonal blocks).  Returns ``(dx, iterations)``.  The
    JAX package's device ``while_loop`` becomes a loop whose stopping test
    stays on the device: once it fails, a flag freezes the iterates, so
    they and the count are the ``while_loop``'s, and the host reads the
    flag every :data:`CHECK_EVERY` iterations.
    """
    Hd, Hss = damped_diag(system, lam)
    Msinv = 1.0 / Hss

    if preconditioner == "tridiag":
        from slam_tpu_torch.solver import tridiag

        factors = tridiag.build_cr_factors(
            *tridiag.extract_tridiag(system, edges, Hd))

        def precond(r: Update) -> Update:
            return Update(poses=tridiag.cr_solve(factors, r.poses),
                          switches=Msinv * r.switches)
    elif preconditioner == "jacobi":
        Minv = _inv_blocks(Hd)

        def precond(r: Update) -> Update:
            return Update(poses=_bmv(Minv, r.poses),
                          switches=Msinv * r.switches)
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    r = Update(poses=-system.g, switches=-system.gs)  # b - A*0
    x = Update(torch.zeros_like(r.poses), torch.zeros_like(r.switches))
    p = precond(r)
    rz = _dot(r, p)
    tol2 = (rtol * (torch.sqrt(_dot(r, r)) + 1e-30)) ** 2
    running = _dot(r, r) > tol2
    iters = torch.zeros((), dtype=torch.int64, device=rz.device)
    for k in range(max_iters):
        if k % CHECK_EVERY == 0 and not bool(running):
            break
        Ap = matvec(system, edges, Hd, Hss, p)
        alpha = rz / (_dot(p, Ap) + 1e-30)
        x_new = Update(x.poses + alpha * p.poses,
                       x.switches + alpha * p.switches)
        r_new = Update(r.poses - alpha * Ap.poses,
                       r.switches - alpha * Ap.switches)
        z = precond(r_new)
        rz_new = _dot(r_new, z)
        beta = rz_new / (rz + 1e-30)
        p_new = Update(z.poses + beta * p.poses,
                       z.switches + beta * p.switches)
        x, r, p = (_where(running, x_new, x), _where(running, r_new, r),
                   _where(running, p_new, p))
        rz = torch.where(running, rz_new, rz)
        iters = iters + running.to(torch.int64)
        running = running & (_dot(r, r) > tol2)
    return x, int(iters)
