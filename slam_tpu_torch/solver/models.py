"""Edge-measurement models.  Port of ``slam_tpu/solver/models.py``; SE(2)
only (SE(3) is ROADMAP A12)."""

from __future__ import annotations

from slam_tpu_torch.geometry import se2


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
