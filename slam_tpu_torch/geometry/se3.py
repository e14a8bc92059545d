"""SE(3) pose-graph residuals on ``(..., 7)`` tensors ``[x, y, z, qw, qx,
qy, qz]`` (unit quaternions).

Port of ``slam_tpu/geometry/se3.py``.  Updates live in the 6-dim right
tangent space ``[dt, dtheta]`` via ``T <- T * Exp(xi)``; the residual is
``[trans(diff), Log(rot(diff))]`` with ``diff = meas^-1 (Ta^-1 Tb)``.  The
solver takes its Jacobians by forward-mode autodiff of the lifted residual
(``solver/models.py``), so every function here keeps the JAX package's
derivative at the points the solver evaluates: the double-``where`` on the
squared norm in :func:`quat_exp` and :func:`quat_log` (finite at theta = 0)
and ``torch.minimum``/``torch.maximum`` where JAX clips (both split the
tangent at a tie, where ``torch.clamp`` passes all of it).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Quaternion primitives ([w, x, y, z], unit norm).
# ---------------------------------------------------------------------------

def quat_mul(p: Tensor, q: Tensor) -> Tensor:
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
        ],
        dim=-1,
    )


def quat_conj(q: Tensor) -> Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vectors ``v [..., 3]`` by unit quaternions ``q [..., 4]``."""
    qv = q[..., 1:]
    w = q[..., 0:1]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def quat_exp(theta: Tensor) -> Tensor:
    """Exponential map: rotation vector ``theta [..., 3]`` -> unit
    quaternion, with Taylor branches smooth in the squared norm."""
    sq = torch.sum(theta * theta, dim=-1, keepdim=True)
    small = sq < 1e-12
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    angle = torch.sqrt(sq_safe)
    half = 0.5 * angle
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, k * theta], dim=-1)


def quat_log(q: Tensor) -> Tensor:
    """Log map: unit quaternion -> rotation vector (angle * axis),
    sign-canonicalised to the minimal rotation.  The per-quaternion scalars
    keep a trailing axis: under ``vmap``, forward-mode AD of a 0-d float32
    tensor times a Python float gives a float64 tangent."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    one = torch.ones((), dtype=q.dtype, device=q.device)
    w = torch.minimum(torch.maximum(q[..., 0:1], -one), one)  # jnp.clip
    vec = q[..., 1:]
    sq = torch.sum(vec * vec, dim=-1, keepdim=True)
    small = sq < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    angle = 2.0 * torch.atan2(n, w)
    # Near identity: log ~= 2 * vec / w (smooth in sq).
    scale = torch.where(small, 2.0 / torch.maximum(w, 1e-6 * one),
                        angle / n)
    return scale * vec


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# SE(3) poses [x y z qw qx qy qz].
# ---------------------------------------------------------------------------

def compose(p: Tensor, q: Tensor) -> Tensor:
    t = p[..., :3] + quat_rotate(p[..., 3:], q[..., :3])
    r = quat_mul(p[..., 3:], q[..., 3:])
    return torch.cat([t, quat_normalize(r)], dim=-1)


def inverse(p: Tensor) -> Tensor:
    qc = quat_conj(p[..., 3:])
    return torch.cat([-quat_rotate(qc, p[..., :3]), qc], dim=-1)


def relative(pa: Tensor, pb: Tensor) -> Tensor:
    return compose(inverse(pa), pb)


def retract(p: Tensor, xi: Tensor) -> Tensor:
    """Right-multiplicative retraction ``T * Exp([dt, dtheta])``."""
    dt = xi[..., :3]
    dth = xi[..., 3:]
    t = p[..., :3] + quat_rotate(p[..., 3:], dt)
    r = quat_normalize(quat_mul(p[..., 3:], quat_exp(dth)))
    return torch.cat([t, r], dim=-1)


def residual(pa: Tensor, pb: Tensor, meas: Tensor) -> Tensor:
    """6-dim edge residual ``[trans(diff), Log(rot(diff))]``."""
    diff = compose(inverse(meas), relative(pa, pb))
    return torch.cat([diff[..., :3], quat_log(diff[..., 3:])], dim=-1)
