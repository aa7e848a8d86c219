"""Host-side SO(3) helpers (numpy, float64) used to bake joint-origin
transforms into constants. Port of ``ikflow_tpu/math/so3.py``'s host helpers."""

from __future__ import annotations

import numpy as np


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
