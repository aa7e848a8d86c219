from ikflow_tpu_torch.math.quaternion import (
    geodesic_distance,
    quat_conjugate,
    quat_from_matrix,
    quat_log_map,
    quat_mul,
    quat_normalize,
)
from ikflow_tpu_torch.math.so3 import rpy_to_matrix_np, skew_np

__all__ = [
    "geodesic_distance",
    "quat_conjugate",
    "quat_from_matrix",
    "quat_log_map",
    "quat_mul",
    "quat_normalize",
    "rpy_to_matrix_np",
    "skew_np",
]
