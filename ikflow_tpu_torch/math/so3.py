"""SO(3) helpers. Port of ``ikflow_tpu/math/so3.py``: host-side numpy
(float64) helpers that bake joint-origin transforms into constants, and
Rodrigues and the rotation log on torch tensors."""

from __future__ import annotations

import numpy as np
import torch

from ikflow_tpu_torch.math.quaternion import quat_from_matrix, quat_log_map


def rpy_to_matrix_np(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """URDF rpy (extrinsic x-y-z == Rz @ Ry @ Rx) -> 3x3 rotation."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    Ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return Rz @ Ry @ Rx


def skew_np(v: np.ndarray) -> np.ndarray:
    """Skew-symmetric matrix of a 3-vector."""
    x, y, z = v
    return np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])


def axis_angle_to_matrix(K: torch.Tensor, KK: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues with the axis's skew matrix K and K @ K given: theta (...,)
    -> (..., 3, 3)."""
    s = torch.sin(theta)[..., None, None]
    c1 = (1.0 - torch.cos(theta))[..., None, None]
    return torch.eye(3, dtype=theta.dtype, device=theta.device) + s * K + c1 * KK


def rotation_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of rotation matrices (..., 3, 3) -> (..., 3), through
    the quaternion log, which is stable at every angle."""
    return quat_log_map(quat_from_matrix(R))
