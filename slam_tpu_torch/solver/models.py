"""Edge-measurement models.  Port of ``slam_tpu/solver/models.py``.

* :class:`SE2Model` -- D=3 additive parameters, closed-form analytic
  Jacobians.
* :class:`SE3Model` -- D_param=7 (quaternion), D_tangent=6, right
  retraction; Jacobians by forward-mode autodiff of the lifted residual,
  batched over the edges (``torch.func.vmap(torch.func.jacfwd(...))``,
  the counterpart of the JAX ``jax.vmap(jax.jacfwd(...))``).
"""

from __future__ import annotations

import torch

from slam_tpu_torch.geometry import se2, se3


class SE2Model:
    """SE(2): tangent == parameters, additive retraction."""

    tangent_dim = 3      # per-node unknowns
    residual_dim = 3
    pose_dim = 3         # storage width
    dcs_dims = 2         # DCS uses ex^2 + ey^2 (ceres_error.cpp:186)

    @staticmethod
    def residual(pa, pb, meas):
        return se2.residual(pa, pb, meas)

    @staticmethod
    def residual_and_jacobians(pa, pb, meas):
        return se2.residual_and_jacobians(pa, pb, meas)

    @staticmethod
    def retract(poses, delta):
        return poses + delta


def _lifted_se3(xi_a, xi_b, pa, pb, meas):
    return se3.residual(se3.retract(pa, xi_a), se3.retract(pb, xi_b), meas)


_se3_jac = torch.func.vmap(torch.func.jacfwd(_lifted_se3, argnums=(0, 1)))


class SE3Model:
    """SE(3): quaternion storage, 6-dim right tangent."""

    tangent_dim = 6
    residual_dim = 6
    pose_dim = 7
    dcs_dims = 3  # translation part of the residual

    @staticmethod
    def residual(pa, pb, meas):
        return se3.residual(pa, pb, meas)

    @staticmethod
    def residual_and_jacobians(pa, pb, meas):
        zero = torch.zeros(pa.shape[:-1] + (6,), dtype=pa.dtype,
                           device=pa.device)
        e = se3.residual(pa, pb, meas)
        Ja, Jb = _se3_jac(zero, zero, pa, pb, meas)
        return e, Ja, Jb

    @staticmethod
    def retract(poses, delta):
        return se3.retract(poses, delta)


def model_for_dim(dim: int):
    """The model of a graph whose poses are ``dim`` wide (3 or 7)."""
    if dim == 3:
        return SE2Model
    if dim == 7:
        return SE3Model
    raise ValueError(f"no pose model of width {dim}")
