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

B problems of one size (``build_woodbury_ops(seeds=B)``, the port of
``jax.vmap(woodbury_solve)`` over ops built with ``pad_to``) hold each
problem's low-rank edges, padded to the problems' largest count C with
columns that add exactly nothing: no gathered row reaches a plan, so
they place no diagonal block and a zero column of U, whose core row is
the identity's.  The rows are still one gather launch, U's ``(B, N, C)``
block grid and the diagonals one scatter launch, the chain one
lane-axis cyclic-reduction solve.  Each problem's K x K core is formed,
factored and solved by the calls that solve it alone (not a batched
matmul and triangular solves: the correction ``z - W y`` cancels, so a
last-bit difference in one step grew to 1.5e-7 m over the rescue's 50
float64 iterations on INTEL+50), and a failed factor gives NaN in its
own problem only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.ops.gather import SegmentPlan, gather_rows, \
    scatter_add_groups, segment_plan
from slam_tpu_torch.solver import tridiag
from slam_tpu_torch.solver.linear import Update, damped_blocks, \
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
    * ``seeds``: None, or B problems: ``lowrank`` (B*C,) holds each
      problem's C columns in turn (padding: edge 0 of its problem, in no
      plan) and ``plan_u`` places them in a ``(B, N/B, C)`` block grid
    """

    lowrank: Tensor
    plan_a: SegmentPlan
    plan_b: SegmentPlan
    plan_u: SegmentPlan
    seeds: int | None = None

    @property
    def num_lowrank(self) -> int:
        """Columns (edges) of ``U`` per problem."""
        return self.lowrank.shape[0] // (self.seeds or 1)


def build_woodbury_ops(ij: np.ndarray, n: int, device="cpu",
                       seeds: int | None = None) -> WoodburyOps:
    """Classify edges: |a - b| == 1 lives in the tridiagonal ``T``, every
    other edge (loop closures, bogus loops, short odometry skips, padded
    self-loops of weight 0) becomes ``R`` Woodbury columns.

    ``seeds=B`` reads ``ij`` as B problems of ``E/B`` edges over ``n/B``
    nodes in turn, every edge inside its problem (``solver/batch.py``),
    and pads each problem's low-rank count to the largest, as the JAX
    package's ``pad_to`` does for its callers."""
    ij = np.asarray(ij, np.int64)
    S = seeds or 1
    E, m = ij.shape[0] // S, n // S
    if seeds is not None and (E * S != ij.shape[0] or m * S != n or np.any(
            ij // m != (np.arange(ij.shape[0]) // E)[:, None])):
        raise ValueError(f"{ij.shape[0]} edges over {n} nodes are not "
                         f"{seeds} problems of the same size")
    low = np.abs(ij[:, 0] - ij[:, 1]) != 1
    per = [np.flatnonzero(low[s * E:(s + 1) * E]) + s * E for s in range(S)]
    c = max(len(p) for p in per)
    # Column k of problem s is column s*c + k; padding reads edge s*E.
    lowrank = np.concatenate([np.concatenate([p, np.full(c - len(p), s * E)])
                              for s, p in enumerate(per)])
    cols = np.concatenate([np.arange(len(p)) for p in per])
    real = np.concatenate([np.arange(len(p)) + s * c
                           for s, p in enumerate(per)])
    a, b = ij[lowrank[real], 0], ij[lowrank[real], 1]
    return WoodburyOps(
        lowrank=torch.as_tensor(lowrank.astype(np.int32), device=device),
        plan_a=segment_plan(a, n, src=real, device=device),
        plan_b=segment_plan(b, n, src=real, device=device),
        # Node g = lane * m + row, column k lands at (lane*m + row)*c + k.
        plan_u=segment_plan(np.concatenate([a * c + cols, b * c + cols]),
                            n * c, src=np.concatenate([real, S * c + real]),
                            device=device,
                            grid=((seeds,) if seeds else (), m, c)),
        seeds=seeds)


def woodbury_solve(system: BlockSystem, edges: EdgeSet, ops: WoodburyOps,
                   lam: Tensor) -> Update:
    """Solve ``(H + lam D) dx = -g`` exactly by chain + low-rank
    Woodbury; on ops of B problems (``seeds``, ``lam`` per node) each
    problem's system."""
    n, B, _ = system.Hdiag.shape
    E, R, _ = system.Ja.shape
    dtype, dev = system.Hdiag.dtype, system.Hdiag.device
    S = ops.seeds
    lead = () if S is None else (S,)
    m = n // (S or 1)         # nodes per problem
    C = ops.num_lowrank
    K = C * R
    if R != B:
        raise ValueError(f"U's block grid takes square blocks, got "
                         f"residual {R} x tangent {B}")

    Hd = damped_blocks(system, lam)
    D, Uoff = tridiag.extract_tridiag(system, edges, Hd, S)
    zero_sw = torch.zeros((E,), dtype=dtype, device=dev)
    b = -system.g.reshape(*lead, m, B)
    if C == 0:
        return Update(poses=tridiag.cr_solve(
            tridiag.build_cr_factors(D, Uoff), b).reshape(n, B),
            switches=zero_sw)

    # The low-rank edges' rows [Ja | Jb | w] in one gather.
    rows = gather_rows(torch.cat([system.Ja.reshape(E, -1),
                                  system.Jb.reshape(E, -1),
                                  system.w[:, None]], dim=1), ops.lowrank)
    Cg = rows.shape[0]
    Ja = rows[:, :R * B].reshape(Cg, R, B)
    Jb = rows[:, R * B:2 * R * B].reshape(Cg, R, B)
    w = rows[:, -1]
    # Whitened columns, each edge's block U[a, :, c] = sqrt(w) Ja^T (B, R).
    sqw = torch.sqrt(torch.clamp(w, min=0.0))[:, None, None]
    JaT = (sqw * Ja).transpose(-1, -2).reshape(Cg, B * R)
    JbT = (sqw * Jb).transpose(-1, -2).reshape(Cg, B * R)
    Haa = w[:, None, None] * torch.einsum("cki,ckj->cij", Ja, Ja)
    Hbb = w[:, None, None] * torch.einsum("cki,ckj->cij", Jb, Jb)
    Sa, Sb, U = scatter_add_groups([
        (Haa.reshape(Cg, B * B), ops.plan_a),
        (Hbb.reshape(Cg, B * B), ops.plan_b),
        (torch.cat([JaT, JbT]), ops.plan_u)])
    # Remove their diagonal contributions from T: U U^T carries them.
    D = D - Sa.reshape(D.shape) - Sb.reshape(D.shape)
    factors = tridiag.build_cr_factors(D, Uoff)
    U = U.reshape(*lead, m, B, K)

    # One multi-RHS chain solve for [b | U].
    Y = tridiag.cr_solve_mrhs(factors, torch.cat([b[..., None], U], dim=-1))
    z, W = Y[..., 0], Y[..., 1:]

    if S is None:
        dp, info = _core_solve(U, z, W)
    else:
        lanes = [_core_solve(U[k], z[k], W[k]) for k in range(S)]
        dp = torch.stack([d for d, _ in lanes])
        info = torch.stack([i for _, i in lanes])
    return Update(poses=nan_unless_factored(dp.reshape(n, B), info, S),
                  switches=zero_sw)


def _core_solve(U: Tensor, z: Tensor, W: Tensor) -> tuple[Tensor, Tensor]:
    """``z - W (I + U^T W)^-1 U^T z`` of one problem (``U``, ``W`` (n, B,
    K), ``z`` (n, B)) through its dense K x K core, and the core's
    Cholesky info."""
    n, B, K = U.shape
    Uf = U.reshape(n * B, K)
    core = torch.eye(K, dtype=U.dtype, device=U.device) \
        + Uf.T @ W.reshape(n * B, K)
    rhs_core = Uf.T @ z.reshape(n * B)
    L, info = torch.linalg.cholesky_ex(core)
    y = torch.cholesky_solve(rhs_core[:, None], L)[:, 0]
    return z - torch.einsum("nbk,k->nb", W, y), info
