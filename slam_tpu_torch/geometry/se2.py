"""SE(2) pose-graph residuals on ``(..., 3)`` tensors ``[x, y, theta]``.

Port of ``slam_tpu/geometry/se2.py``: closed-form residual with the
reference's ``asin(sin(.))`` angle fold, and analytic 3x3 Jacobians.  All
functions map over arbitrary leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def relative(pa: Tensor, pb: Tensor) -> Tensor:
    """``Ta^-1 Tb`` -- pose of ``b`` in the frame of ``a``."""
    dx = pb[..., 0] - pa[..., 0]
    dy = pb[..., 1] - pa[..., 1]
    ca, sa = torch.cos(pa[..., 2]), torch.sin(pa[..., 2])
    return torch.stack(
        [ca * dx + sa * dy, -sa * dx + ca * dy, pb[..., 2] - pa[..., 2]],
        dim=-1,
    )


def wrap_angle(t: Tensor) -> Tensor:
    """Wrap angle(s) to ``[-pi, pi)``."""
    return torch.remainder(t + math.pi, 2.0 * math.pi) - math.pi


def fold_angle(t: Tensor) -> Tensor:
    """The reference's ``asin(sin(t))`` sawtooth fold to ``[-pi/2, pi/2]``."""
    return torch.asin(torch.clamp(torch.sin(t), -1.0, 1.0))


def residual(pa: Tensor, pb: Tensor, meas: Tensor) -> Tensor:
    """Edge residual ``[e0, e1, asin(sin(tb - ta - tm))]``."""
    rel = relative(pa, pb)
    mx, my, mt = meas[..., 0], meas[..., 1], meas[..., 2]
    cm, sm = torch.cos(mt), torch.sin(mt)
    vx = rel[..., 0] - mx
    vy = rel[..., 1] - my
    e0 = cm * vx + sm * vy
    e1 = -sm * vx + cm * vy
    e2 = fold_angle(rel[..., 2] - mt)
    return torch.stack([e0, e1, e2], dim=-1)


def residual_and_jacobians(
    pa: Tensor, pb: Tensor, meas: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """Residual plus analytic Jacobians ``(e, Ja, Jb)``, shapes ``[..., 3]``
    and ``[..., 3, 3]`` (derivation in ``slam_tpu/geometry/se2.py``)."""
    ta = pa[..., 2]
    ca, sa = torch.cos(ta), torch.sin(ta)
    mt = meas[..., 2]
    cm, sm = torch.cos(mt), torch.sin(mt)
    dx = pb[..., 0] - pa[..., 0]
    dy = pb[..., 1] - pa[..., 1]

    wx = ca * dx + sa * dy - meas[..., 0]
    wy = -sa * dx + ca * dy - meas[..., 1]
    e0 = cm * wx + sm * wy
    e1 = -sm * wx + cm * wy
    dt = pb[..., 2] - ta - mt
    e2 = torch.asin(torch.clamp(torch.sin(dt), -1.0, 1.0))
    e = torch.stack([e0, e1, e2], dim=-1)

    cma = torch.cos(mt + ta)
    sma = torch.sin(mt + ta)
    gx = -sa * dx + ca * dy
    gy = -ca * dx - sa * dy
    ht_x = cm * gx + sm * gy
    ht_y = -sm * gx + cm * gy
    sgn = torch.sign(torch.cos(dt))  # 0 at cos(dt) == 0, like jnp.sign

    zeros = torch.zeros_like(e0)
    Ja = torch.stack(
        [
            torch.stack([-cma, -sma, ht_x], dim=-1),
            torch.stack([sma, -cma, ht_y], dim=-1),
            torch.stack([zeros, zeros, -sgn], dim=-1),
        ],
        dim=-2,
    )
    Jb = torch.stack(
        [
            torch.stack([cma, sma, zeros], dim=-1),
            torch.stack([-sma, cma, zeros], dim=-1),
            torch.stack([zeros, zeros, sgn], dim=-1),
        ],
        dim=-2,
    )
    return e, Ja, Jb


def retract(p: Tensor, delta: Tensor) -> Tensor:
    """Additive retraction (the reference optimises raw ``double[3]``)."""
    return p + delta
