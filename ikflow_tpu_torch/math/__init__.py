from ikflow_tpu_torch.math.quaternion import (
    geodesic_distance,
    quat_conjugate,
    quat_from_axis_angle,
    quat_from_matrix,
    quat_log_map,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
)
from ikflow_tpu_torch.math.so3 import axis_angle_to_matrix, rotation_log, rpy_to_matrix_np, skew_np

__all__ = [
    "axis_angle_to_matrix",
    "geodesic_distance",
    "quat_conjugate",
    "quat_from_axis_angle",
    "quat_from_matrix",
    "quat_log_map",
    "quat_mul",
    "quat_normalize",
    "quat_rotate",
    "quat_to_matrix",
    "rotation_log",
    "rpy_to_matrix_np",
    "skew_np",
]
