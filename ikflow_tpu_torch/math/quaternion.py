"""Quaternion operations in (w, x, y, z) convention on torch tensors.

Port of ``ikflow_tpu/math/quaternion.py``. All functions are batched over
leading dimensions.
"""

from __future__ import annotations

import torch

# Keeps acos away from |dot| == 1.
_ACOS_EPS = 1e-7


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """[w, -x, -y, -z]. Uploads nothing, so a CUDA graph may capture it."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both (..., 4) wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    qvec, w = q[..., 1:], q[..., :1]
    qvec, v = torch.broadcast_tensors(qvec, v)
    t = 2.0 * torch.linalg.cross(qvec, v, dim=-1)
    return v + w * t + torch.linalg.cross(qvec, t, dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Branch-free Shepperd: all four pivot constructions are built and the one
    with the largest pivot term is selected per element.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22  # 4w^2
    tx = 1.0 + m00 - m11 - m22  # 4x^2
    ty = 1.0 - m00 + m11 - m22  # 4y^2
    tz = 1.0 - m00 - m11 + m22  # 4z^2

    sw, sx, sy, sz = (torch.sqrt(torch.clamp(t, min=1e-12)) for t in (tw, tx, ty, tz))

    q_w = torch.stack([sw * sw, m21 - m12, m02 - m20, m10 - m01], dim=-1) / (2.0 * sw[..., None])
    q_x = torch.stack([m21 - m12, sx * sx, m01 + m10, m02 + m20], dim=-1) / (2.0 * sx[..., None])
    q_y = torch.stack([m02 - m20, m01 + m10, sy * sy, m12 + m21], dim=-1) / (2.0 * sy[..., None])
    q_z = torch.stack([m10 - m01, m02 + m20, m12 + m21, sz * sz], dim=-1) / (2.0 * sz[..., None])

    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)[..., None]
    q = torch.where(best == 0, q_w, torch.where(best == 1, q_x, torch.where(best == 2, q_y, q_z)))
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3) and angle (...,) -> quaternion (..., 4)."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


def geodesic_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle in [0, pi] between unit quaternions: 2 acos(|<q1, q2>|), with the
    dot product clipped at 1 - 1e-7."""
    dot = torch.sum(q1 * q2, dim=-1)
    dot = torch.clamp(torch.abs(dot), 0.0, 1.0 - _ACOS_EPS)
    return 2.0 * torch.arccos(dot)


def quat_log_map(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector of a unit quaternion: (..., 4) -> (..., 3), with
    ||omega|| the rotation angle in [0, pi]. Safe at the identity."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vec = q[..., 1:]
    norm_v = torch.linalg.norm(vec, dim=-1)
    angle = 2.0 * torch.atan2(norm_v, w)
    scale = torch.where(
        norm_v > 1e-9, angle / torch.clamp(norm_v, min=1e-12), 2.0 / torch.clamp(w, min=1e-12)
    )
    return vec * scale[..., None]
