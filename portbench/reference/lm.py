"""Plain reference of one request: Levenberg-Marquardt on each lane's
robust SE(2) pose graph, from the arrays the benchmark made.

Written from the semantics alone, with plain torch operations:

- the SE(2) edge residual: the relative pose of ``b`` in ``a``'s frame
  minus the measurement, rotated into the measurement's frame, its angle
  folded by ``asin(sin(.))`` (the DCS-ceres residual);
- the robust kernel on loop edges (closures and bogus loops): dynamic
  covariance scaling, ``psi = min(1, sqrt(2 phi / (phi + ex^2 + ey^2)))``
  times the residual, or joint switchable constraints, ``s * e`` with one
  switch variable a loop edge and the prior residual ``sqrt(lam) (1 - s)``;
- a Huber loss of width ``delta`` on every edge's squared (scaled)
  residual; the normal equations weight each edge by the loss's first
  derivative (iteratively reweighted least squares);
- the Jacobians by forward-mode differentiation of that residual, edge by
  edge (``torch.func``), so no hand-derived derivative is shared with the
  program;
- node 0 of each lane held fixed; every other pose, and every live loop
  edge's switch, an unknown;
- the damped system ``(H + lam * diag(clip(diag H, 1e-6, 1e32))) dx = -g``
  assembled densely and solved by Cholesky (a failed factor rejects the
  step);
- ``iters`` iterations of the fixed-iteration rule: accept when the new
  cost is below the old; on acceptance ``lam = max(lam / 3, 1e-12)`` and
  ``nu = 2``, on rejection ``lam = min(lam * nu, 1e10)`` and ``nu *= 2``.

:func:`solve` runs every lane in float64 (``dtype``), one lane at a time,
on the device of its inputs.  ``tf32=True`` rounds every operand of the
assembly and of the factor's products to TF32's 10-bit mantissa before
the float32 product: the benchmark's control, the reference put in the
program's place at the next precision below float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

DIAG_MIN = 1e-6
DIAG_MAX = 1e32


class Lane(NamedTuple):
    """One problem as host arrays: ``poses`` (N, 3), ``ij`` (E, 2),
    ``meas`` (E, 3), ``loop`` (E,) bool: a closure or bogus loop."""

    poses: np.ndarray
    ij: np.ndarray
    meas: np.ndarray
    loop: np.ndarray


class Settings(NamedTuple):
    robust: str          # "dcs" or "sc"
    dcs_phi: float
    huber_delta: float
    sc_prior_lambda: float
    init_lambda: float
    min_lambda: float
    max_lambda: float
    iters: int


class LaneResult(NamedTuple):
    poses: Tensor        # (N, 3)
    switches: Tensor     # (E,) 1 on edges without a switch
    cost0: float
    cost: float
    accepted: int


def round_tf32(x: Tensor) -> Tensor:
    """``x`` (float32) rounded to nearest on TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def edge_residual(pa: Tensor, pb: Tensor, m: Tensor) -> Tensor:
    """Residual of one edge (``pa``, ``pb``, ``m`` of shape (3,))."""
    c, s = torch.cos(pa[2]), torch.sin(pa[2])
    dx, dy = pb[0] - pa[0], pb[1] - pa[1]
    rx = c * dx + s * dy - m[0]
    ry = -s * dx + c * dy - m[1]
    cm, sm = torch.cos(m[2]), torch.sin(m[2])
    ang = torch.asin(torch.clamp(torch.sin(pb[2] - pa[2] - m[2]), -1.0, 1.0))
    return torch.stack([cm * rx + sm * ry, -sm * rx + cm * ry, ang])


def _robust_residual(pa, pb, s, m, loop, robust: str, phi: float):
    e = edge_residual(pa, pb, m)
    if robust == "dcs":
        psi = torch.minimum(torch.sqrt(2.0 * phi / (phi + e[0] ** 2
                                                    + e[1] ** 2)),
                            torch.ones((), dtype=e.dtype, device=e.device))
        scale = psi
    else:
        scale = s
    return torch.where(loop, scale * e, e)


def _huber(s2: Tensor, delta: float) -> tuple[Tensor, Tensor]:
    """Huber's rho and its first derivative at squared norms ``s2``."""
    d2 = delta * delta
    r = torch.sqrt(torch.clamp(s2, min=d2))
    rho = torch.where(s2 <= d2, s2, 2.0 * delta * r - d2)
    w = torch.where(s2 <= d2, torch.ones_like(s2), delta / r)
    return rho, w


class _Problem:
    """One lane on the device: its unknowns and its per-edge functions."""

    def __init__(self, lane: Lane, st: Settings, dtype, device):
        self.st = st
        self.kw = dict(dtype=dtype, device=device)
        self.a = torch.as_tensor(lane.ij[:, 0], device=device).long()
        self.b = torch.as_tensor(lane.ij[:, 1], device=device).long()
        self.meas = torch.as_tensor(lane.meas, **self.kw)
        self.loop = torch.as_tensor(lane.loop, device=device)
        self.N, self.E = lane.poses.shape[0], lane.ij.shape[0]
        # unknowns: 3 per node but node 0, then one switch a loop edge (sc)
        self.np_ = 3 * (self.N - 1)
        sw = np.flatnonzero(lane.loop) if st.robust == "sc" else \
            np.zeros(0, np.int64)
        self.sw_edges = torch.as_tensor(sw, device=device).long()
        self.n = self.np_ + sw.size
        col = torch.full((self.E,), -1, dtype=torch.long, device=device)
        col[self.sw_edges] = self.np_ + torch.arange(sw.size, device=device)
        self.sw_col = col
        fn = lambda pa, pb, s, m, lp: _robust_residual(  # noqa: E731
            pa, pb, s, m, lp, st.robust, st.dcs_phi)
        self._res = torch.func.vmap(fn)
        self._jac = torch.func.vmap(torch.func.jacfwd(fn, argnums=(0, 1, 2)))

    def cost(self, poses: Tensor, switches: Tensor) -> Tensor:
        r = self._res(poses[self.a], poses[self.b], switches, self.meas,
                      self.loop)
        rho, _ = _huber(torch.sum(r * r, dim=-1), self.st.huber_delta)
        c = 0.5 * torch.sum(rho)
        if self.st.robust == "sc":
            pr = math.sqrt(self.st.sc_prior_lambda) * (
                1.0 - switches[self.sw_edges])
            c = c + 0.5 * torch.sum(pr * pr)
        return c

    def system(self, poses: Tensor, switches: Tensor, tf32: bool):
        """The undamped normal equations ``H`` (n, n) and ``g`` (n,)."""
        pa, pb = poses[self.a], poses[self.b]
        r = self._res(pa, pb, switches, self.meas, self.loop)
        Ja, Jb, Js = self._jac(pa, pb, switches, self.meas, self.loop)
        _, w = _huber(torch.sum(r * r, dim=-1), self.st.huber_delta)
        # columns of each edge's Jacobian: a's 3, b's 3, its switch
        J = torch.cat([Ja, Jb, Js[:, :, None]], dim=-1)       # (E, 3, 7)
        cols = torch.cat([3 * (self.a[:, None] - 1)
                          + torch.arange(3, device=self.a.device),
                          3 * (self.b[:, None] - 1)
                          + torch.arange(3, device=self.a.device),
                          self.sw_col[:, None]], dim=1)       # (E, 7)
        # node 0 and edges without a switch have no column
        keep = torch.cat([(self.a != 0)[:, None].expand(-1, 3),
                          (self.b != 0)[:, None].expand(-1, 3),
                          (self.sw_col >= 0)[:, None]], dim=1)
        J = J * keep[:, None, :]
        if tf32:
            J, rr = round_tf32(J), round_tf32(r)
        else:
            rr = r
        Hb = w[:, None, None] * torch.einsum("eki,ekj->eij", J, J)
        gb = w[:, None] * torch.einsum("eki,ek->ei", J, rr)
        cols = torch.where(keep, cols, torch.zeros_like(cols))
        H = torch.zeros((self.n, self.n), **self.kw)
        g = torch.zeros((self.n,), **self.kw)
        Hb = Hb * (keep[:, :, None] & keep[:, None, :])
        gb = gb * keep
        H.index_put_((cols[:, :, None].expand(-1, 7, 7).reshape(-1),
                      cols[:, None, :].expand(-1, 7, 7).reshape(-1)),
                     Hb.reshape(-1), accumulate=True)
        g.index_put_((cols.reshape(-1),), gb.reshape(-1), accumulate=True)
        if self.st.robust == "sc":
            lam = self.st.sc_prior_lambda
            idx = self.sw_col[self.sw_edges]
            pr = math.sqrt(lam) * (1.0 - switches[self.sw_edges])
            H[idx, idx] += lam
            g[idx] += -math.sqrt(lam) * pr
        return H, g


def cholesky_solve(A: Tensor, b: Tensor, tf32: bool) -> Tensor | None:
    """``A^-1 b`` by Cholesky of the Jacobi-equilibrated ``A`` (unit
    diagonal), None when ``A`` is not positive definite.  With ``tf32`` a
    right-looking blocked factor whose trailing updates take TF32-rounded
    operands."""
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-12))
    y = _cholesky_solve(A * s[:, None] * s[None, :], b * s, tf32)
    return None if y is None else s * y


def _cholesky_solve(A: Tensor, b: Tensor, tf32: bool) -> Tensor | None:
    if not tf32:
        L, info = torch.linalg.cholesky_ex(A)
        if int(info) != 0:
            return None
        return torch.cholesky_solve(b[:, None], L)[:, 0]
    n, nb = A.shape[0], 256
    A = A.clone()
    for k in range(0, n, nb):
        e = min(k + nb, n)
        Lkk, info = torch.linalg.cholesky_ex(A[k:e, k:e])
        if int(info) != 0:
            return None
        A[k:e, k:e] = Lkk
        if e < n:
            Lik = torch.linalg.solve_triangular(
                Lkk, A[e:, k:e].T, upper=False).T
            A[e:, k:e] = Lik
            t = round_tf32(Lik)
            A[e:, e:] -= t @ t.T
    L = torch.tril(A)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


def solve_lane(lane: Lane, st: Settings, device, dtype=torch.float64,
               tf32: bool = False) -> LaneResult:
    """``st.iters`` LM iterations of one lane from its poses, every switch
    1."""
    if tf32:
        dtype = torch.float32
    prob = _Problem(lane, st, dtype, device)
    poses = torch.as_tensor(lane.poses, dtype=dtype, device=device)
    switches = torch.ones((prob.E,), dtype=dtype, device=device)
    cost = prob.cost(poses, switches)
    cost0 = float(cost)
    lam, nu, accepted = st.init_lambda, 2.0, 0
    for _ in range(st.iters):
        H, g = prob.system(poses, switches, tf32)
        d = torch.clamp(torch.diagonal(H), DIAG_MIN, DIAG_MAX)
        dx = cholesky_solve(H + torch.diag(lam * d), -g, tf32)
        new_cost = None
        if dx is not None and bool(torch.isfinite(dx).all()):
            step = torch.zeros((prob.N, 3), dtype=dtype, device=device)
            step[1:] = dx[:prob.np_].reshape(-1, 3)
            new_poses = poses + step
            new_switches = switches.clone()
            new_switches[prob.sw_edges] += dx[prob.np_:]
            new_cost = prob.cost(new_poses, new_switches)
        if new_cost is not None and bool(new_cost < cost):
            poses, switches, cost = new_poses, new_switches, new_cost
            lam, nu = max(lam / 3.0, st.min_lambda), 2.0
            accepted += 1
        else:
            lam, nu = min(lam * nu, st.max_lambda), nu * 2.0
    return LaneResult(poses=poses, switches=switches, cost0=cost0,
                      cost=float(cost), accepted=accepted)


def lane_cost(lane: Lane, st: Settings, poses: Tensor, switches: Tensor,
              dtype=torch.float64) -> float:
    """The objective of ``lane`` at given poses (N, 3) and switches (E,)."""
    prob = _Problem(lane, st, dtype, poses.device)
    return float(prob.cost(poses.to(dtype), switches.to(dtype)))


def solve(lanes: list[Lane], st: Settings, device, dtype=torch.float64,
          tf32: bool = False) -> list[LaneResult]:
    """Every lane, one at a time."""
    return [solve_lane(lane, st, device, dtype, tf32) for lane in lanes]
