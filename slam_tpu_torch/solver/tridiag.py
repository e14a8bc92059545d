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

Every function also takes B problems' chains at once, with a lane axis
in front (``(B, N, D, D)`` blocks, ``(B, N, D[, K])`` right-hand sides),
as ``jax.vmap`` of the JAX functions computes them: each lane is padded
to its own power of two and reduced by its own recursion, all lanes in
the same batched matmuls.  An edge never joins
two lanes, so the couplings across a lane boundary are zero and are
sliced away.  One problem's shapes and arithmetic are unchanged.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.solver.linear import _bmv, _inv_blocks
from slam_tpu_torch.solver.linearize import BlockSystem
from slam_tpu_torch.solver.problem import EdgeSet

Tensor = torch.Tensor


def extract_tridiag(system: BlockSystem, edges: EdgeSet, Hd: Tensor,
                    seeds: int | None = None) -> tuple[Tensor, Tensor]:
    """Damped diagonal blocks ``D (N, B, B)`` and super-diagonal blocks
    ``U (N-1, B, B)``, ``U[i] = H[i, i+1]``: an edge (a, a+1) adds
    ``Hoff`` at a, an edge (a, a-1) adds ``Hoff^T`` at a-1; both sums in
    one ``scatter_add_rows`` launch.  With ``seeds=S`` the system is S
    problems of ``N / S`` nodes each, and the blocks come lane by lane:
    ``(S, N/S, B, B)`` and ``(S, N/S - 1, B, B)``."""
    n, B = Hd.shape[0], Hd.shape[-1]
    a, b = edges.ij[:, 0], edges.ij[:, 1]
    E = edges.num_edges
    fwd = (b - a == 1).to(Hd.dtype)
    rev = (a - b == 1).to(Hd.dtype)
    U, = edges.node_sums(
        (fwd[:, None] * system.Hoff.reshape(E, -1),
         rev[:, None] * system.Hoff.transpose(-1, -2).reshape(E, -1)))
    if seeds is None:
        return Hd, U.reshape(n, B, B)[:n - 1]
    m = n // seeds
    return (Hd.reshape(seeds, m, B, B),
            U.reshape(seeds, m, B, B)[:, :m - 1])


def _t(x: Tensor) -> Tensor:
    return x.transpose(-1, -2)


def _sl(x: Tensor, ax: int, start: int | None, stop: int | None = None,
        step: int | None = None) -> Tensor:
    """``x[start:stop:step]`` along the block axis ``ax`` (0, or 1 behind
    a lane axis)."""
    return x[(slice(None),) * ax + (slice(start, stop, step),)]


def build_cr_factors(D: Tensor, U: Tensor):
    """Cyclic-reduction factorisation of the SPD block tridiagonal
    ``(D, U)``: ``(levels, root_inv, m, n)`` for :func:`cr_solve`.  Each
    level holds ``(Dinv_odd, U_left, U_right)``: for odd block ``2t+1``,
    ``U_left[t] = U[2t]`` couples it to even ``2t`` and ``U_right[t] =
    U[2t+1]`` (zero at the tail) to even ``2t+2``.  Lanes (``D (S, N, B,
    B)``, ``U (S, N-1, B, B)``) keep their axis in front of every
    factor, so that a strided level of all lanes is one batched matmul
    with no copy."""
    ax = D.dim() - 3
    lead, n, B = D.shape[:ax], D.shape[ax], D.shape[-1]
    m = 1
    while m < n:
        m *= 2
    kw = dict(dtype=D.dtype, device=D.device)
    D = torch.cat([D, torch.eye(B, **kw).expand(*lead, m - n, B, B)], dim=ax)
    U = torch.cat([U, torch.zeros((*lead, m - 1 - U.shape[ax], B, B), **kw)],
                  dim=ax)
    zero = torch.zeros((*lead, 1, B, B), **kw)

    levels = []
    while D.shape[ax] > 1:
        t = D.shape[ax] // 2
        D_even, D_odd = _sl(D, ax, 0, None, 2), _sl(D, ax, 1, None, 2)
        U_left = _sl(U, ax, 0, None, 2)
        U_right = _sl(torch.cat([_sl(U, ax, 1, None, 2), zero], dim=ax), ax,
                      None, t)
        Dinv_odd = _inv_blocks(D_odd)
        UD = U_left @ Dinv_odd
        right_term = UD @ _t(U_left)
        left_src = (_t(U_right) @ Dinv_odd) @ U_right
        left_term = torch.cat([zero, _sl(left_src, ax, None, t - 1)], dim=ax)
        D_new = D_even - right_term - left_term
        U_new = _sl(-(UD @ U_right), ax, None, t - 1)
        levels.append((Dinv_odd, U_left, U_right))
        D, U = D_new, U_new
    return levels, _inv_blocks(D), m, n


def _cr(factors, r: Tensor, mv, mv_t) -> Tensor:
    """The recursion of :func:`cr_solve` with block products ``mv`` and
    ``mv_t`` (by the block and by its transpose), along the block axis of
    ``r`` (``(N, ...)``, or ``(S, N, ...)`` on lanes' factors)."""
    levels, root_inv, m, n = factors
    ax = root_inv.dim() - 3
    shape = list(r.shape)
    shape[ax] = m - n
    r = torch.cat([r, r.new_zeros(shape)], dim=ax)
    shape[ax] = 1
    zero = r.new_zeros(shape)

    odd_rhs = []
    for Dinv_odd, U_left, U_right in levels:
        r_even, r_odd = _sl(r, ax, 0, None, 2), _sl(r, ax, 1, None, 2)
        zp = mv(Dinv_odd, r_odd)
        right_term = mv(U_left, zp)
        left_term = torch.cat([zero, _sl(mv_t(U_right, zp), ax, None, -1)],
                              dim=ax)
        odd_rhs.append(r_odd)
        r = r_even - right_term - left_term

    z = mv(root_inv, r)
    for (Dinv_odd, U_left, U_right), r_odd in zip(reversed(levels),
                                                  reversed(odd_rhs)):
        t = r_odd.shape[ax]
        z_next = torch.cat([_sl(z, ax, 1), zero], dim=ax)
        rhs = r_odd - mv_t(U_left, z) - mv(U_right, z_next)
        z_odd = mv(Dinv_odd, rhs)
        z = torch.stack([z, z_odd], dim=ax + 1).reshape(
            *r.shape[:ax], 2 * t, *r.shape[ax + 1:])
    return _sl(z, ax, None, n)


def cr_solve(factors, r: Tensor) -> Tensor:
    """Solve the block-tridiagonal system for ``r (N, B)``, or each
    lane's for ``r (S, N, B)``."""
    return _cr(factors, r, _bmv, lambda m, v: _bmv(_t(m), v))


def cr_solve_mrhs(factors, r: Tensor) -> Tensor:
    """Solve for ``K`` right-hand sides at once: ``r (N, B, K)`` ->
    ``(N, B, K)`` (lanes: ``(S, N, B, K)``); every block-vector product
    becomes a batched ``(B, B) @ (B, K)`` matmul."""
    return _cr(factors, r, torch.matmul, lambda m, v: _t(m) @ v)
