"""Dense linear solve of the damped normal equations ``(H + lam D) dx = -g``.

Port of the CPU path of ``slam_tpu/solver/linear.py::dense_solve``: the
block system is assembled into a dense matrix by one ``scatter_add_rows``
over block-pair indices (the plan is built once per graph by
:func:`dense_plan`; its block grid lands the blocks straight in the
row-major matrix), Jacobi-equilibrated and Cholesky-factored.  Pose
unknowns only: the joint switch system of method 2 is ROADMAP A9.
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


class Update(NamedTuple):
    poses: Tensor     # (N, D) tangent-space pose updates
    switches: Tensor  # (E,)


def damped_diag(system: BlockSystem, lam: Tensor) -> Tensor:
    """``Hdiag + lam * clip(diag(Hdiag))`` on the block diagonal."""
    d = torch.diagonal(system.Hdiag, dim1=-2, dim2=-1)
    damp = lam * torch.clamp(d, _DIAG_MIN, _DIAG_MAX)
    return system.Hdiag + torch.diag_embed(damp)


def nan_unless_factored(x: Tensor, info: Tensor) -> Tensor:
    """NaN where a Cholesky failed, as JAX's ``cho_factor`` reports it, so
    the LM loop rejects the step; checked without a host sync."""
    return torch.where(torch.all(info == 0), x, torch.full_like(x, np.nan))


def dense_plan(edges: EdgeSet) -> SegmentPlan:
    """Scatter plan of ``[Hd (n), Hoff (E), Hoff^T (E)]`` blocks into the
    ``n x n`` grid of D x D blocks (segment ``row * n + col``) of the
    ``(n*D, n*D)`` matrix."""
    n = edges.num_nodes
    ij = edges.ij.cpu().numpy().astype(np.int64)
    a, b = ij[:, 0], ij[:, 1]
    nodes = np.arange(n)
    idx = np.concatenate([nodes * n + nodes, a * n + b, b * n + a])
    return segment_plan(idx, n * n, device=edges.ij.device, grid=((), n, n))


def dense_solve(system: BlockSystem, edges: EdgeSet, lam: Tensor,
                plan: SegmentPlan) -> Update:
    """Exact damped solve through the dense Jacobi-equilibrated Cholesky."""
    n, D = system.Hdiag.shape[0], system.Hdiag.shape[-1]
    E = edges.num_edges
    blocks = torch.cat([damped_diag(system, lam), system.Hoff,
                        system.Hoff.transpose(-1, -2)]).reshape(-1, D * D)
    H = scatter_add_rows(blocks, plan)
    rhs = -system.g.reshape(-1)
    # Jacobi equilibration improves f32 conditioning markedly.
    dscale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H * dscale[:, None] * dscale[None, :]
    L, info = torch.linalg.cholesky_ex(Hs)
    sol = torch.cholesky_solve((rhs * dscale)[:, None], L)[:, 0] * dscale
    sol = nan_unless_factored(sol, info)
    return Update(poses=sol.reshape(n, D),
                  switches=torch.zeros((E,), dtype=sol.dtype,
                                       device=sol.device))
