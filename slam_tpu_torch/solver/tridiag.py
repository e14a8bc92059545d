"""Block-tridiagonal (odometry-chain) preconditioner by cyclic reduction.

Port of ``slam_tpu/solver/tridiag.py``.  The block-tridiagonal part of the
damped normal matrix -- node diagonals and the couplings of consecutive
nodes -- holds the odometry chain's stiffness; solving it is PCG's
preconditioner.  Block cyclic reduction eliminates the odd blocks level by
level: log2(N) levels, each a batch of D x D inverses and products over a
halving array.  The block count is padded to a power of two with decoupled
identity blocks.  Every product is a full float32 (or float64) batched
matmul: the device set-up turns TF32 off, as the JAX package pins
``Precision.HIGHEST`` here.

The factors are built once per LM iteration and reused by every CG
iteration.  :func:`cr_solve_mrhs` is the same recursion for many
right-hand sides at once.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.solver.linear import _inv_blocks
from slam_tpu_torch.solver.linearize import BlockSystem
from slam_tpu_torch.solver.problem import EdgeSet

Tensor = torch.Tensor


def extract_tridiag(system: BlockSystem, edges: EdgeSet,
                    Hd: Tensor) -> tuple[Tensor, Tensor]:
    """Damped diagonal blocks ``D (N, B, B)`` and super-diagonal blocks
    ``U (N-1, B, B)``, ``U[i] = H[i, i+1]``: an edge (a, a+1) adds
    ``Hoff`` at a, an edge (a, a-1) adds ``Hoff^T`` at a-1; both sums in
    one ``scatter_add_rows`` launch."""
    n, B = Hd.shape[0], Hd.shape[-1]
    a, b = edges.ij[:, 0], edges.ij[:, 1]
    E = edges.num_edges
    fwd = (b - a == 1).to(Hd.dtype)
    rev = (a - b == 1).to(Hd.dtype)
    U, = edges.node_sums(
        (fwd[:, None] * system.Hoff.reshape(E, -1),
         rev[:, None] * system.Hoff.transpose(-1, -2).reshape(E, -1)))
    return Hd, U.reshape(n, B, B)[:n - 1]


def _t(x: Tensor) -> Tensor:
    return x.transpose(-1, -2)


def _bmv(m: Tensor, v: Tensor) -> Tensor:
    return (m @ v[..., None])[..., 0]


def build_cr_factors(D: Tensor, U: Tensor):
    """Cyclic-reduction factorisation of the SPD block tridiagonal
    ``(D, U)``: ``(levels, root_inv, m, n)`` for :func:`cr_solve`.  Each
    level holds ``(Dinv_odd, U_left, U_right)``: for odd block ``2t+1``,
    ``U_left[t] = U[2t]`` couples it to even ``2t`` and ``U_right[t] =
    U[2t+1]`` (zero at the tail) to even ``2t+2``."""
    n, B, _ = D.shape
    m = 1
    while m < n:
        m *= 2
    kw = dict(dtype=D.dtype, device=D.device)
    D = torch.cat([D, torch.eye(B, **kw).expand(m - n, B, B)])
    U = torch.cat([U, torch.zeros((m - 1 - U.shape[0], B, B), **kw)])
    zero = torch.zeros((1, B, B), **kw)

    levels = []
    while D.shape[0] > 1:
        t = D.shape[0] // 2
        D_even, D_odd = D[0::2], D[1::2]
        U_left = U[0::2]
        U_right = torch.cat([U[1::2], zero])[:t]
        Dinv_odd = _inv_blocks(D_odd)
        UD = U_left @ Dinv_odd
        right_term = UD @ _t(U_left)
        left_src = (_t(U_right) @ Dinv_odd) @ U_right
        left_term = torch.cat([zero, left_src[:t - 1]])
        D_new = D_even - right_term - left_term
        U_new = -(UD @ U_right)[:t - 1]
        levels.append((Dinv_odd, U_left, U_right))
        D, U = D_new, U_new
    return levels, _inv_blocks(D), m, n


def _cr(factors, r: Tensor, mv, mv_t) -> Tensor:
    """The recursion of :func:`cr_solve` with block products ``mv`` and
    ``mv_t`` (by the block and by its transpose)."""
    levels, root_inv, m, n = factors
    r = torch.cat([r, r.new_zeros((m - n, *r.shape[1:]))])
    zero = r.new_zeros((1, *r.shape[1:]))

    odd_rhs = []
    for Dinv_odd, U_left, U_right in levels:
        r_even, r_odd = r[0::2], r[1::2]
        zp = mv(Dinv_odd, r_odd)
        right_term = mv(U_left, zp)
        left_term = torch.cat([zero, mv_t(U_right, zp)[:-1]])
        odd_rhs.append(r_odd)
        r = r_even - right_term - left_term

    z = mv(root_inv, r)
    for (Dinv_odd, U_left, U_right), r_odd in zip(reversed(levels),
                                                  reversed(odd_rhs)):
        t = r_odd.shape[0]
        z_next = torch.cat([z[1:], zero])
        rhs = r_odd - mv_t(U_left, z) - mv(U_right, z_next)
        z_odd = mv(Dinv_odd, rhs)
        z = torch.stack([z, z_odd], dim=1).reshape(2 * t, *r.shape[1:])
    return z[:n]


def cr_solve(factors, r: Tensor) -> Tensor:
    """Solve the block-tridiagonal system for ``r (N, B)``."""
    return _cr(factors, r, _bmv, lambda m, v: _bmv(_t(m), v))


def cr_solve_mrhs(factors, r: Tensor) -> Tensor:
    """Solve for ``K`` right-hand sides at once: ``r (N, B, K)`` ->
    ``(N, B, K)``; every block-vector product becomes a batched
    ``(B, B) @ (B, K)`` matmul."""
    return _cr(factors, r, torch.matmul, lambda m, v: _t(m) @ v)
