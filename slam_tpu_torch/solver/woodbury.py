"""Chain + low-rank Woodbury direct solver.

Port of ``slam_tpu/solver/woodbury.py``.  A pose graph is an odometry
chain plus sparse loop closures, so the damped normal matrix splits
exactly as

    H + lam D = T + U U^T

where ``T`` is the block-tridiagonal part (every edge between consecutive
nodes, and all diagonal, damping and gauge terms) and ``U`` stacks the
whitened Jacobian columns of the ``C`` other edges (R columns per edge).
The Woodbury identity turns the solve into

    x = T^-1 b - T^-1 U (I + U^T T^-1 U)^-1 U^T T^-1 b

-- one multi-right-hand-side cyclic-reduction solve of ``T``
(``solver/tridiag.py``) and one dense ``K x K`` Cholesky, ``K = R C``.

``T`` is built by subtracting the low-rank edges' diagonal blocks from
the assembled ``Hdiag``, so ``T + U U^T`` is the damped system in exact
arithmetic.  In float32 the correction ``z - W y`` cancels where the
closures carry most of the stiffness (the JAX package's measurement); the
solver is exact in float64.

The JAX package selects the low-rank edges and their endpoints with
(C, E) and (C, N) one-hot matrices.  Here :class:`WoodburyOps` holds index
vectors and two scatter plans, built once per graph: the low-rank rows
are one ``gather_rows`` launch, and ``U`` (placed as D x D blocks of an
``(N*D, C*R)`` block grid) and the subtracted diagonal blocks are one
``scatter_add_rows`` launch of three groups.  Like the Schur path it
takes the robust modes without extra unknowns; joint SC eliminates its
switches first (``solver/lm.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.ops.gather import SegmentPlan, gather_rows, \
    scatter_add_groups, segment_plan
from slam_tpu_torch.solver import tridiag
from slam_tpu_torch.solver.linear import Update, damped_diag, \
    nan_unless_factored
from slam_tpu_torch.solver.linearize import BlockSystem
from slam_tpu_torch.solver.problem import EdgeSet

Tensor = torch.Tensor


class WoodburyOps(NamedTuple):
    """Static per-graph operators of the Woodbury solve.

    * ``lowrank`` (C,) int32: the low-rank edges
    * ``plan_a``/``plan_b``: their a/b endpoints' diagonal blocks -> nodes
    * ``plan_u``: [a blocks (C), b blocks (C)] -> the ``(N, C)`` block
      grid of ``U``
    """

    lowrank: Tensor
    plan_a: SegmentPlan
    plan_b: SegmentPlan
    plan_u: SegmentPlan

    @property
    def num_lowrank(self) -> int:
        return self.lowrank.shape[0]


def build_woodbury_ops(ij: np.ndarray, n: int,
                       device="cpu") -> WoodburyOps:
    """Classify edges: |a - b| == 1 lives in the tridiagonal ``T``, every
    other edge (loop closures, bogus loops, short odometry skips, padded
    self-loops of weight 0) becomes ``R`` Woodbury columns."""
    ij = np.asarray(ij, np.int64)
    idx = np.flatnonzero(np.abs(ij[:, 0] - ij[:, 1]) != 1)
    c = len(idx)
    k = np.arange(c)
    a, b = ij[idx, 0], ij[idx, 1]
    return WoodburyOps(
        lowrank=torch.as_tensor(idx.astype(np.int32), device=device),
        plan_a=segment_plan(a, n, src=k, device=device),
        plan_b=segment_plan(b, n, src=k, device=device),
        plan_u=segment_plan(np.concatenate([a * c + k, b * c + k]), n * c,
                            src=np.concatenate([k, c + k]), device=device,
                            grid=((), n, c)),
    )


def woodbury_solve(system: BlockSystem, edges: EdgeSet, ops: WoodburyOps,
                   lam: Tensor) -> Update:
    """Solve ``(H + lam D) dx = -g`` exactly by chain + low-rank
    Woodbury."""
    n, B, _ = system.Hdiag.shape
    E, R, _ = system.Ja.shape
    dtype, dev = system.Hdiag.dtype, system.Hdiag.device
    C = ops.num_lowrank
    K = C * R
    if R != B:
        raise ValueError(f"U's block grid takes square blocks, got "
                         f"residual {R} x tangent {B}")

    Hd, _ = damped_diag(system, lam)
    D, Uoff = tridiag.extract_tridiag(system, edges, Hd)
    zero_sw = torch.zeros((E,), dtype=dtype, device=dev)
    if C == 0:
        return Update(poses=tridiag.cr_solve(
            tridiag.build_cr_factors(D, Uoff), -system.g), switches=zero_sw)

    # The low-rank edges' rows [Ja | Jb | w] in one gather.
    rows = gather_rows(torch.cat([system.Ja.reshape(E, -1),
                                  system.Jb.reshape(E, -1),
                                  system.w[:, None]], dim=1), ops.lowrank)
    Ja = rows[:, :R * B].reshape(C, R, B)
    Jb = rows[:, R * B:2 * R * B].reshape(C, R, B)
    w = rows[:, -1]
    # Whitened columns, each edge's block U[a, :, c] = sqrt(w) Ja^T (B, R).
    sqw = torch.sqrt(torch.clamp(w, min=0.0))[:, None, None]
    JaT = (sqw * Ja).transpose(-1, -2).reshape(C, B * R)
    JbT = (sqw * Jb).transpose(-1, -2).reshape(C, B * R)
    Haa = w[:, None, None] * torch.einsum("cki,ckj->cij", Ja, Ja)
    Hbb = w[:, None, None] * torch.einsum("cki,ckj->cij", Jb, Jb)
    Sa, Sb, U = scatter_add_groups([
        (Haa.reshape(C, B * B), ops.plan_a),
        (Hbb.reshape(C, B * B), ops.plan_b),
        (torch.cat([JaT, JbT]), ops.plan_u)])
    # Remove their diagonal contributions from T: U U^T carries them.
    D = D - Sa.reshape(n, B, B) - Sb.reshape(n, B, B)
    factors = tridiag.build_cr_factors(D, Uoff)
    U = U.reshape(n, B, K)

    # One multi-RHS chain solve for [b | U].
    Y = tridiag.cr_solve_mrhs(
        factors, torch.cat([-system.g[:, :, None], U], dim=-1))
    z, W = Y[:, :, 0], Y[:, :, 1:]

    # The dense K x K core.
    Uf = U.reshape(n * B, K)
    core = torch.eye(K, dtype=dtype, device=dev) \
        + Uf.T @ W.reshape(n * B, K)
    rhs_core = Uf.T @ z.reshape(n * B)
    L, info = torch.linalg.cholesky_ex(core)
    y = torch.cholesky_solve(rhs_core[:, None], L)[:, 0]
    dp = z - torch.einsum("nbk,k->nb", W, y)
    return Update(poses=nan_unless_factored(dp, info), switches=zero_sw)
