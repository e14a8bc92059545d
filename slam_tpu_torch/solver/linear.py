"""Linear solves of the damped normal equations ``(H + lam D) dx = -g``.

Port of ``slam_tpu/solver/linear.py`` (its CPU paths; the one-hot
incidence operators were a TPU workaround).  Vectors over the unknowns are
a pair ``(poses (N, D), switches (E,))``; the switches are unknowns of
method 2's joint system (``robust="sc"``) and solve to 0 otherwise.

- ``dense_solve``: the system is assembled into a dense matrix by one
  ``scatter_add_rows`` launch over a block grid (the plan is built once
  per graph by :func:`dense_plan`), Jacobi-equilibrated and
  Cholesky-factored.  With the switches it is the joint system: one
  unknown per edge after the node-major pose unknowns.  On a batch of B
  problems (:class:`DenseBatchPlan`, ``solver/batch.py``) each problem's
  pose-only system is its own matrix of a ``(B, D*n, D*n)`` stack, all
  assembled by one launch; so is each problem's joint system under a
  :class:`JointPlan` with ``seeds``.  The stack is equilibrated and
  factored by ``ops.stack_chol.stack_cholesky``: on the card one
  hand-written blocked Cholesky whose every launch serves all lanes (it
  replaced a ``cholesky_ex`` call a lane, which left most of the H100
  idle: PERF.md), on the CPU ``cholesky_ex`` a lane.  Either way each
  problem's factor is its own alone to the bit, as ``jax.vmap`` of the
  JAX ``dense_solve`` factors each; one problem is a stack of one.
- ``eliminate_switches``: the exact elimination of the diagonal switch
  block, so that method 2 rides the pose-only Schur and Woodbury solvers
  (B problems' too, each problem's switches damped by its own lambda);
  its per-node corrections are one grouped ``scatter_add_rows`` launch.
- ``pcg_solve``: preconditioned conjugate gradients on the joint system;
  each matvec is one ``gather_rows`` and one grouped ``scatter_add_rows``
  launch, and the stopping test is read on the host only every
  :data:`CHECK_EVERY` iterations.  On B problems (:class:`PCGPlan` with
  ``seeds=B``) each lane has its own CG scalars and stopping test, as
  ``jax.vmap`` of the JAX ``pcg_solve`` runs them, and each launch serves
  all lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.ops.gather import SegmentPlan, scatter_add_rows, \
    segment_plan
from slam_tpu_torch.ops.stack_chol import stack_cholesky
from slam_tpu_torch.solver.linearize import BlockSystem
from slam_tpu_torch.solver.problem import EdgeSet
from slam_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

# Ceres clamps the LM diagonal to [1e-6, 1e32].
_DIAG_MIN = 1e-6
_DIAG_MAX = 1e32
#: CG iterations between two host reads of the stopping test.
CHECK_EVERY = 8


class Update(NamedTuple):
    poses: Tensor     # (N, D) tangent-space pose updates
    switches: Tensor  # (E,)


def damped_blocks(system: BlockSystem, lam: Tensor) -> Tensor:
    """LM-damped diagonal blocks ``Hdiag + lam * clip(diag(Hdiag))``; ``lam``
    is a scalar, or one per node in a batch."""
    d = torch.diagonal(system.Hdiag, dim1=-2, dim2=-1)
    return system.Hdiag + torch.diag_embed(
        lam * torch.clamp(d, _DIAG_MIN, _DIAG_MAX))


def damped_switches(system: BlockSystem, lam: Tensor,
                    seeds: int | None = None) -> Tensor:
    """The damped switch diagonal ``Hss + lam * clip(Hss)``; for B problems
    (``seeds``, ``lam`` per node) each problem's switches take its own
    ``lam``."""
    lam_s = lam if seeds is None else lane_rows(
        lam.reshape(seeds, -1)[:, 0], system.Hss, seeds)
    return system.Hss + lam_s * torch.clamp(system.Hss, _DIAG_MIN, _DIAG_MAX)


def damped_diag(system: BlockSystem, lam: Tensor,
                seeds: int | None = None) -> tuple[Tensor, Tensor]:
    """LM-damped diagonal blocks (:func:`damped_blocks`) and the damped
    switch diagonal (:func:`damped_switches`)."""
    return damped_blocks(system, lam), damped_switches(system, lam, seeds)


def lane_rows(v: Tensor, like: Tensor, seeds: int | None) -> Tensor:
    """``v`` as it broadcasts over ``like``'s rows: unchanged for one
    problem; for B problems each problem's entry of ``(B,)`` repeated over
    its block of ``like.shape[0] / B`` rows."""
    if seeds is None:
        return v
    n = like.shape[0]
    return v[:, None].expand(seeds, n // seeds).reshape(
        (n,) + (1,) * (like.dim() - 1))


def nan_unless_factored(x: Tensor, info: Tensor,
                        seeds: int | None = None) -> Tensor:
    """NaN where a Cholesky failed, as JAX's ``cho_factor`` reports it, so
    the LM loop rejects the step; checked without a host sync.  With
    ``seeds=B``, ``x`` and ``info`` hold B problems' entries in turn along
    their first axis, and only the problems whose factor failed get NaN."""
    if seeds is None:
        return torch.where(torch.all(info == 0), x,
                           torch.full_like(x, np.nan))
    ok = (info.reshape(seeds, -1) == 0).all(-1)[:, None]
    per = x.reshape(seeds, -1)
    return torch.where(ok, per, torch.full_like(per, np.nan)).reshape(x.shape)


# ---------------------------------------------------------------------------
# Dense solve
# ---------------------------------------------------------------------------

class JointPlan(NamedTuple):
    """Dense assembly of the joint pose-and-switch system: ``plan`` places
    D x D blocks in an ``(n + m) x (n + m)`` block grid, ``m = ceil(E/D)``;
    switch ``e`` is unknown ``D*n + e``, row ``e % D`` (``row_sel``, a
    one-hot (E, D)) of block row ``n + e // D``.  With ``seeds=B`` the
    nodes and edges are B problems' (``n / B`` and ``E / B`` each), each
    problem's grid its own of a ``(B, w, w)`` stack, and ``e`` is the
    switch's index in its own problem."""

    plan: SegmentPlan
    row_sel: Tensor
    seeds: int | None = None


class DenseBatchPlan(NamedTuple):
    """Dense assembly of B problems' pose-only systems: ``plan`` places
    each problem's D x D blocks in its own ``m x m`` block grid of a
    ``(B, m, m)`` stack, ``m = n / B`` (segment ``(lane * m + row) * m +
    col``)."""

    plan: SegmentPlan
    seeds: int


def dense_plan(edges: EdgeSet, switches: bool = False,
               seeds: int | None = None):
    """Scatter plan of ``[Hd (n), Hoff (E), Hoff^T (E)]`` blocks into the
    ``n x n`` grid of D x D blocks (segment ``row * n + col``) of the
    ``(n*D, n*D)`` matrix; with ``switches`` a :class:`JointPlan` that
    also places, per edge, its switch diagonal and its couplings to both
    endpoints (a self-loop's two couplings add).  ``seeds=B`` reads the
    edges as B problems of ``n / B`` nodes each, every edge inside one
    (``solver/batch.py``), and returns a :class:`DenseBatchPlan`, or with
    ``switches`` a :class:`JointPlan` of B problems of ``E / B`` edges,
    problem k's at ``[k*E/B, (k+1)*E/B)``."""
    n, E, D = edges.num_nodes, edges.num_edges, edges.tangent_dim
    ij = edges.ij.cpu().numpy().astype(np.int64)
    a, b = ij[:, 0], ij[:, 1]
    nodes = np.arange(n)
    dev = edges.ij.device
    if seeds is not None:
        m = n // seeds
        if m * seeds != n or np.any(a // m != b // m):
            raise ValueError(f"{E} edges over {n} nodes are not {seeds} "
                             "problems of the same size")
        if switches:
            return _joint_batch_plan(edges, a, b, seeds)
        # Node g = lane * m + row lands at (lane * m + row) * m + g % m.
        idx = np.concatenate([nodes * m + nodes % m, a * m + b % m,
                              b * m + a % m])
        return DenseBatchPlan(segment_plan(idx, n * m, device=dev,
                                           grid=((seeds,), m, m)), seeds)
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


def _joint_batch_plan(edges: EdgeSet, a: np.ndarray, b: np.ndarray,
                      seeds: int) -> JointPlan:
    """:func:`dense_plan`'s joint plan of ``seeds`` problems: each
    problem's ``w x w`` block grid, ``w = m + ceil(Eb / D)`` (``m`` nodes
    and ``Eb`` edges a problem), is its own of a ``(B, w, w)`` stack, and
    each block lands where the problem's own :class:`JointPlan` puts it
    (segment ``(lane * w + row) * w + col``)."""
    n, E, D = edges.num_nodes, edges.num_edges, edges.tangent_dim
    m, Eb = n // seeds, E // seeds
    lane_e, e = np.divmod(np.arange(E), Eb)
    if Eb * seeds != E or np.any(a // m != lane_e):
        raise ValueError(f"{E} edges are not {seeds} problems' blocks of "
                         "the same size, each over its own nodes")
    w = m + -(-Eb // D)
    nodes = np.arange(n)
    ca, cb, cs = a % m, b % m, m + e // D  # columns inside a lane's grid
    ra, rb = (a // m) * w + ca, (b // m) * w + cb
    rs = lane_e * w + cs                   # rows of the (B*w, w) stack
    idx = np.concatenate([((nodes // m) * w + nodes % m) * w + nodes % m,
                          ra * w + cb, rb * w + ca, rs * w + cs,
                          rs * w + ca, ra * w + cs, rs * w + cb,
                          rb * w + cs])
    dev = edges.ij.device
    row_sel = torch.eye(D, dtype=edges.meas.dtype, device=dev)[
        torch.as_tensor(e % D, device=dev)]
    return JointPlan(segment_plan(idx, seeds * w * w, device=dev,
                                  grid=((seeds,), w, w)), row_sel, seeds)


def cho_solve_stack(L: Tensor, b: Tensor) -> Tensor:
    """``A^-1 b`` for each factor ``L`` of a ``(B, n, n)`` stack and its
    ``(B, n, k)`` right-hand sides, by two batched triangular solves:
    ``cholesky_solve`` takes cuSOLVER's ``potrsBatched`` on a stack, which
    ran 9x slower on an H100 at six 3684^2 systems (PERF.md, PR 11)."""
    return torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, b, upper=False), upper=True)


def _finish_dense(H: Tensor, rhs: Tensor, n: int, D: int, E: int,
                  switches: bool) -> Update:
    """Solve ``H x = rhs``, or each system of a ``(B, D*n, D*n)`` stack
    (``n`` nodes a problem); a failed factor gives NaN in its own problem
    only.  One system is factored and solved as a stack of one."""
    with span("dense.factor"):
        # Jacobi equilibration improves f32 conditioning markedly; the
        # factor applies it as it stages the stack.
        dscale = 1.0 / torch.sqrt(torch.clamp(
            torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
        L, info = stack_cholesky(H.reshape((-1,) + H.shape[-2:]),
                                 dscale.reshape(-1, H.shape[-1]))
    with span("dense.substitute"):
        b = (rhs * dscale).reshape(L.shape[0], -1, 1)
        y = cho_solve_stack(L, b).reshape(rhs.shape)
        sol = nan_unless_factored(y * dscale, info,
                                  H.shape[0] if H.dim() == 3 else None)
        ds = sol[..., D * n:].reshape(-1) if switches else torch.zeros(
            (E,), dtype=sol.dtype, device=sol.device)
        return Update(poses=sol[..., :D * n].reshape(-1, D), switches=ds)


def dense_solve(system: BlockSystem, edges: EdgeSet, lam: Tensor,
                plan) -> Update:
    """Exact damped solve through the dense Jacobi-equilibrated Cholesky:
    pose unknowns under a :class:`SegmentPlan`, the joint system with one
    switch unknown per edge under a :class:`JointPlan`, B problems' pose
    unknowns under a :class:`DenseBatchPlan` or their joint systems under
    a :class:`JointPlan` with ``seeds`` (``lam`` then per node)."""
    n, D = system.Hdiag.shape[0], system.Hdiag.shape[-1]
    E = edges.num_edges
    switches = isinstance(plan, JointPlan)
    seeds = getattr(plan, "seeds", None)
    with span("dense.assemble"):
        rows = [damped_blocks(system, lam), system.Hoff,
                system.Hoff.transpose(-1, -2)]
        rhs = -system.g.reshape(-1)
        if seeds is not None:
            rhs = rhs.reshape(seeds, -1)
            n //= seeds
        if switches:
            Hss = damped_switches(system, lam, seeds)
            sel = plan.row_sel
            Sa = sel[:, :, None] * system.Hps_a[:, None, :]
            Sb = sel[:, :, None] * system.Hps_b[:, None, :]
            rows += [Hss[:, None, None] * (sel[:, :, None]
                                           * sel[:, None, :]),
                     Sa, Sa.transpose(-1, -2), Sb, Sb.transpose(-1, -2)]
            rhs = torch.cat([rhs, -system.gs.reshape(rhs.shape[:-1]
                                                     + (-1,))], dim=-1)
        if seeds is not None or switches:
            plan = plan.plan
        H = scatter_add_rows(torch.cat(rows).reshape(-1, D * D), plan)
    dim = rhs.shape[-1]
    return _finish_dense(H[..., :dim, :dim], rhs, n, D, E, switches)


# ---------------------------------------------------------------------------
# Switch elimination (method 2 on the pose-only solvers)
# ---------------------------------------------------------------------------

def eliminate_switches(system: BlockSystem, edges: EdgeSet, lam: Tensor,
                       seeds: int | None = None):
    """Exactly eliminate the switch unknowns from the damped joint system.

    ``Hss`` is diagonal, so the Schur complement onto the poses is a
    closed-form per-edge correction of ``Hdiag[a]``, ``Hdiag[b]``,
    ``Hoff[e]`` and ``g[a]``, ``g[b]``, with the damped switch diagonal
    (see the JAX package for why that damping is legitimate;
    :func:`damped_switches`: for B problems, ``seeds``, each problem's
    own ``lam``).  Returns ``(reduced_system, backsub)``; ``backsub(xp)``
    gives the switch updates of the pose update ``xp`` through one
    ``gather_rows`` launch.
    """
    with span("sc.eliminate"):
        E, n, D = system.Hss.shape[0], system.Hdiag.shape[0], \
            system.Hdiag.shape[-1]
        Hss_d = damped_switches(system, lam, seeds)
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
        with span("sc.eliminate"):
            xa, xb = edges.gather_ab(xp)
            return -(system.gs + torch.sum(Hps_a * xa, dim=-1)
                     + torch.sum(Hps_b * xb, dim=-1)) * inv

    return reduced, backsub


# ---------------------------------------------------------------------------
# Preconditioned conjugate gradients
# ---------------------------------------------------------------------------

def _bmv(m: Tensor, v: Tensor) -> Tensor:
    """``m[i] @ v[i]`` for ``m (..., D, D)``, ``v (..., D)``, as an
    elementwise product and a sum over its last axis: each entry is then
    the same whatever the batch around it, so that a problem's lane of a
    batched solve is its solve alone to the bit (a batched matmul is not:
    on the card another batch count takes another cuBLAS kernel)."""
    return (m * v[..., None, :]).sum(-1)


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


class PCGPlan(NamedTuple):
    """PCG's plan: nothing to build, and ``seeds=B`` for B problems of one
    size in turn along the unknowns (``solver/batch.py``)."""

    seeds: int | None = None


class LaneDot:
    """Each of ``seeds`` lanes' dot ``x . y`` as its dot alone, for
    vectors shaped as ``like``: each lane's products are written to a row
    of a buffer that starts on a 512-byte boundary, as a tensor of its own
    does, and summed there in full, since on the card a reduction's vector
    width, and with it the order of its terms, follows its input's
    alignment (a lane's slice of 1533 switches is not aligned so), and a
    row reduction of the ``(B, n)`` view sums in another order still.  The
    buffers and the lanes' views of them are made once, so a dot launches
    2B + 4 kernels (one problem's: 5)."""

    def __init__(self, like: Update, seeds: int):
        self.seeds, self.rows, self.lanes = seeds, [], []
        for v in like:
            n, step = v.numel() // seeds, 512 // v.element_size()
            buf = v.new_empty((seeds, -(-n // step) * step))
            shape = (v.shape[0] // seeds,) + tuple(v.shape[1:])
            self.rows.append(buf[:, :n])
            self.lanes.append([buf[k, :n].view(shape) for k in range(seeds)])

    def __call__(self, x: Update, y: Update) -> Tensor:
        sums = []
        for a, b, rows, lanes in zip(x, y, self.rows, self.lanes):
            torch.mul(a.reshape(rows.shape), b.reshape(rows.shape),
                      out=rows)
            sums += [torch.sum(v) for v in lanes]
        sums = torch.stack(sums)
        return sums[:self.seeds] + sums[self.seeds:]


def _dot(x: Update, y: Update, seeds: int | None = None) -> Tensor:
    """``x . y``, or each problem's of B (``(B,)``): each problem's sums
    are the full reductions of its own products, as alone
    (:class:`LaneDot`), so that its CG scalars and stopping test are its
    solve's alone to the bit (CG carries a last-bit difference into its
    count)."""
    if seeds is None:
        return torch.sum(x.poses * y.poses) + torch.sum(x.switches
                                                        * y.switches)
    return LaneDot(x, seeds)(x, y)


def pcg_solve(system: BlockSystem, edges: EdgeSet, lam: Tensor,
              max_iters: int = 250, rtol: float = 1e-8,
              preconditioner: str = "tridiag",
              seeds: int | None = None) -> tuple[Update, Tensor]:
    """Preconditioned CG on the damped joint normal equations.

    ``preconditioner``: "tridiag" (the block-tridiagonal odometry chain
    solved by cyclic reduction, ``solver/tridiag.py``) or "jacobi" (the
    inverted node-diagonal blocks).  Returns ``(dx, iterations)``, the
    count a 0-d device tensor.  The JAX package's device ``while_loop``
    becomes a loop whose stopping test stays on the device: once it fails,
    a flag freezes the iterates, so they and the count are the
    ``while_loop``'s, and the host reads the flag every
    :data:`CHECK_EVERY` iterations (its only read).

    ``seeds=B``: the system is B problems of one size, ``lam`` per node;
    each has its own ``rz``, ``alpha``, ``beta``, tolerance and flag, as a
    vmapped ``while_loop`` runs them, the count is ``(B,)``, and the loop
    runs until no problem's flag holds.
    """
    Hd, Hss = damped_diag(system, lam, seeds)
    Msinv = 1.0 / Hss

    if preconditioner == "tridiag":
        from slam_tpu_torch.solver import tridiag

        factors = tridiag.build_cr_factors(
            *tridiag.extract_tridiag(system, edges, Hd, seeds))

        def chain(r: Tensor) -> Tensor:
            if seeds is None:
                return tridiag.cr_solve(factors, r)
            return tridiag.cr_solve(
                factors, r.reshape(seeds, -1, r.shape[-1])).reshape(r.shape)

        def precond(r: Update) -> Update:
            return Update(poses=chain(r.poses),
                          switches=Msinv * r.switches)
    elif preconditioner == "jacobi":
        Minv = _inv_blocks(Hd)

        def precond(r: Update) -> Update:
            return Update(poses=_bmv(Minv, r.poses),
                          switches=Msinv * r.switches)
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    lane_dot = None if seeds is None else LaneDot(
        Update(system.g, system.gs), seeds)

    def dot(a: Update, b: Update) -> Tensor:
        return _dot(a, b) if lane_dot is None else lane_dot(a, b)

    def step(v: Tensor, x: Update, y: Update) -> Update:
        """``x + v y``, each problem's ``v`` on its rows."""
        return Update(x.poses + lane_rows(v, y.poses, seeds) * y.poses,
                      x.switches + lane_rows(v, y.switches, seeds)
                      * y.switches)

    def where(flag: Tensor, new: Update, old: Update) -> Update:
        return Update(
            torch.where(lane_rows(flag, new.poses, seeds), new.poses,
                        old.poses),
            torch.where(lane_rows(flag, new.switches, seeds), new.switches,
                        old.switches))

    r = Update(poses=-system.g, switches=-system.gs)  # b - A*0
    x = Update(torch.zeros_like(r.poses), torch.zeros_like(r.switches))
    p = precond(r)
    rz = dot(r, p)
    tol2 = (rtol * (torch.sqrt(dot(r, r)) + 1e-30)) ** 2
    running = dot(r, r) > tol2
    iters = torch.zeros(running.shape, dtype=torch.int64,
                        device=rz.device)
    for k in range(max_iters):
        if k % CHECK_EVERY == 0 and not bool(running.any()):
            break
        Ap = matvec(system, edges, Hd, Hss, p)
        alpha = rz / (dot(p, Ap) + 1e-30)
        x_new = step(alpha, x, p)
        r_new = step(-alpha, r, Ap)
        z = precond(r_new)
        rz_new = dot(r_new, z)
        beta = rz_new / (rz + 1e-30)
        p_new = step(beta, z, p)
        x, r, p = (where(running, x_new, x), where(running, r_new, r),
                   where(running, p_new, p))
        rz = torch.where(running, rz_new, rz)
        iters = iters + running.to(torch.int64)
        running = running & (dot(r, r) > tol2)
    return x, iters
