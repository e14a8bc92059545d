"""Robust kernels: Huber loss, Dynamic Covariance Scaling, switchable
constraints.  Port of ``slam_tpu/robust/kernels.py`` (semantics and the
mapping to the reference are documented there); plain elementwise torch.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def huber_rho(s: Tensor, delta: float) -> Tensor:
    """Ceres ``HuberLoss(delta)`` rho(s) for squared norm ``s``."""
    d2 = delta * delta
    safe = torch.sqrt(torch.clamp(s, min=d2))
    return torch.where(s <= d2, s, 2.0 * delta * safe - d2)


def huber_weight(s: Tensor, delta: float) -> Tensor:
    """IRLS weight ``rho'(s)``: 1 inside the quadratic region, delta/|r| out."""
    d2 = delta * delta
    safe = torch.sqrt(torch.clamp(s, min=d2))
    return torch.where(s <= d2, torch.ones_like(s), delta / safe)


def dcs_psi(e: Tensor, phi: float, dims: int = 2) -> Tensor:
    """``psi = min(1, sqrt(2 phi / (phi + |e[:dims]|^2)))``."""
    res = torch.sum(e[..., :dims] ** 2, dim=-1)
    psi = torch.sqrt(2.0 * phi / (phi + res))
    return torch.clamp(psi, max=1.0)


def _scale_through(e: Tensor, J: Tensor, psi: Tensor, dpsi: Tensor,
                   dims: int) -> Tensor:
    """``psi J + e (dpsi * dr/dx)`` with ``r = |e[:dims]|^2``."""
    drdx = 2.0 * torch.einsum("...k,...kj->...j", e[..., :dims],
                              J[..., :dims, :])
    return psi[..., None, None] * J + (
        e[..., :, None] * (dpsi[..., None] * drdx)[..., None, :]
    )


def dcs_scale(
    e: Tensor, Ja: Tensor, Jb: Tensor, phi: float, dims: int = 2
) -> tuple[Tensor, Tensor, Tensor]:
    """Scale residual and Jacobians by DCS psi, differentiating through psi."""
    r = torch.sum(e[..., :dims] ** 2, dim=-1)
    psi_raw = torch.sqrt(2.0 * phi / (phi + r))
    active = psi_raw < 1.0
    psi = torch.where(active, psi_raw, torch.ones_like(psi_raw))
    dpsi = torch.where(active, -psi / (2.0 * (phi + r)),
                       torch.zeros_like(psi_raw))
    return (psi[..., None] * e, _scale_through(e, Ja, psi, dpsi, dims),
            _scale_through(e, Jb, psi, dpsi, dims))


def switch_scale(
    e: Tensor, Ja: Tensor, Jb: Tensor, s: Tensor
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Switchable-constraints scaling ``s * e``; last output is ``de/ds``."""
    return (s[..., None] * e, s[..., None, None] * Ja,
            s[..., None, None] * Jb, e)


def switch_prior_residual(s: Tensor, lam: float) -> Tensor:
    """Prior residual ``sqrt(lambda) * (1 - s)``."""
    return math.sqrt(lam) * (1.0 - s)


def sc_varpro_scale(
    e: Tensor, Ja: Tensor, Jb: Tensor, lam: float
) -> tuple[Tensor, Tensor, Tensor]:
    """Variable-projection switches: ``s* = lam / (lam + |e|^2)`` substituted
    and differentiated through."""
    r2 = torch.sum(e * e, dim=-1)
    psi = lam / (lam + r2)
    dpsi = -psi * psi / lam
    dims = e.shape[-1]
    return (psi[..., None] * e, _scale_through(e, Ja, psi, dpsi, dims),
            _scale_through(e, Jb, psi, dpsi, dims))


def sc_varpro_switch(e: Tensor, lam: float) -> Tensor:
    """The eliminated switch values ``s*``."""
    return lam / (lam + torch.sum(e * e, dim=-1))
