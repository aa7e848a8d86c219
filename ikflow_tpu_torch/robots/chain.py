"""Serial kinematic chains with batched forward kinematics and the analytic
Jacobian on torch tensors.

Port of ``ikflow_tpu/robots/chain.py`` (``_rollout``, FK, the geometric
Jacobian, joint-limit helpers and sampling). Self-collision is not ported yet.

The chain data is host numpy (float64); per device and dtype it is cast once
into constant tensors. The 3x3 products are written as broadcast
multiply-and-sum, so the rotation chain runs in true fp32 whatever the TF32
flags say.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ikflow_tpu_torch.math.quaternion import quat_from_matrix
from ikflow_tpu_torch.math.so3 import rpy_to_matrix_np, skew_np

REVOLUTE = "revolute"
PRISMATIC = "prismatic"
FIXED = "fixed"


@dataclasses.dataclass(frozen=True)
class Joint:
    """One URDF-style joint: ``xyz``/``rpy`` is the constant transform from
    the parent link frame, ``axis`` the motion axis in the joint frame."""

    name: str
    xyz: Tuple[float, float, float]
    rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    joint_type: str = REVOLUTE
    limits: Optional[Tuple[float, float]] = None

    def __post_init__(self):
        if self.joint_type not in (REVOLUTE, PRISMATIC, FIXED):
            raise ValueError(f"unknown joint type {self.joint_type!r}")
        if self.joint_type != FIXED and self.limits is None:
            raise ValueError(f"actuated joint {self.name} needs limits")


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as an elementwise sum: exact fp32."""
    return (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)


def _rot(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (3,) -> (..., 3)."""
    return (R * v).sum(-1)


class KinematicChain:
    """A serial chain. Every method follows the device and dtype of its input."""

    def __init__(self, name: str, joints: Sequence[Joint]):
        self.name = name
        self.joints = tuple(joints)
        actuated = [j for j in self.joints if j.joint_type != FIXED]
        self._ndof = len(actuated)
        self.actuated_joints_limits: Tuple[Tuple[float, float], ...] = tuple(j.limits for j in actuated)
        self._limits_low = np.array([lim[0] for lim in self.actuated_joints_limits], dtype=np.float64)
        self._limits_high = np.array([lim[1] for lim in self.actuated_joints_limits], dtype=np.float64)
        self._origins_R = [rpy_to_matrix_np(*j.rpy) for j in self.joints]
        self._origins_t = [np.asarray(j.xyz, dtype=np.float64) for j in self.joints]
        self._axes = [np.asarray(j.axis, dtype=np.float64) for j in self.joints]
        self._K = [skew_np(a) for a in self._axes]
        self._KK = [K @ K for K in self._K]
        self._consts: Dict[Tuple[torch.device, torch.dtype], dict] = {}

    @property
    def ndof(self) -> int:
        return self._ndof

    def _constants(self, device, dtype) -> dict:
        key = (torch.device(device), dtype)
        c = self._consts.get(key)
        if c is None:
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
            c = {
                "R": [t(R) for R in self._origins_R],
                "t": [t(x) for x in self._origins_t],
                "axis": [t(a) for a in self._axes],
                "K": [t(K) for K in self._K],
                "KK": [t(KK) for KK in self._KK],
                "eye": torch.eye(3, dtype=dtype, device=device),
                "low": t(self._limits_low),
                "high": t(self._limits_high),
            }
            self._consts[key] = c
        return c

    def limits_low(self, device="cpu", dtype=torch.float32) -> torch.Tensor:
        return self._constants(device, dtype)["low"]

    def limits_high(self, device="cpu", dtype=torch.float32) -> torch.Tensor:
        return self._constants(device, dtype)["high"]

    def _check_q(self, q: torch.Tensor) -> None:
        if q.shape[-1] != self._ndof:
            raise ValueError(f"{self.name}: q last dim must be ndof={self._ndof}, got shape {tuple(q.shape)}")

    def _rollout(self, q: torch.Tensor):
        """Compose the chain. q: (..., ndof). Returns the post-joint frames
        [(R, p)], and the world axis and origin of each actuated joint."""
        self._check_q(q)
        c = self._constants(q.device, q.dtype)
        batch = q.shape[:-1]
        R = c["eye"].expand(batch + (3, 3))
        p = torch.zeros(batch + (3,), dtype=q.dtype, device=q.device)
        frames, world_axes, world_origins = [], [], []
        qi = 0
        for idx, joint in enumerate(self.joints):
            p = p + _rot(R, c["t"][idx])
            R = _mm(R, c["R"][idx])
            if joint.joint_type == REVOLUTE:
                theta = q[..., qi]
                world_axes.append(_rot(R, c["axis"][idx]))
                world_origins.append(p)
                s = torch.sin(theta)[..., None, None]
                c1 = (1.0 - torch.cos(theta))[..., None, None]
                R = _mm(R, c["eye"] + s * c["K"][idx] + c1 * c["KK"][idx])
                qi += 1
            elif joint.joint_type == PRISMATIC:
                world_axis = _rot(R, c["axis"][idx])
                world_axes.append(world_axis)
                world_origins.append(p)
                p = p + q[..., qi, None] * world_axis
                qi += 1
            frames.append((R, p))
        return frames, world_axes, world_origins

    def forward_kinematics(self, q: torch.Tensor) -> torch.Tensor:
        """q (..., ndof) -> pose (..., 7) as [x, y, z, qw, qx, qy, qz]."""
        frames, _, _ = self._rollout(q)
        R, p = frames[-1]
        return torch.cat([p, quat_from_matrix(R)], dim=-1)

    def fk_pose_and_jacobian(self, q: torch.Tensor):
        """(pose (..., 7), J (..., 6, ndof)), J = [J_pos; J_rot]: for a
        revolute joint z x (p_ee - o) and z, for a prismatic joint z and 0."""
        frames, world_axes, world_origins = self._rollout(q)
        R, p_ee = frames[-1]
        pose = torch.cat([p_ee, quat_from_matrix(R)], dim=-1)
        cols_pos, cols_rot = [], []
        actuated = [j for j in self.joints if j.joint_type != FIXED]
        for joint, z, o in zip(actuated, world_axes, world_origins):
            if joint.joint_type == REVOLUTE:
                cols_pos.append(torch.linalg.cross(z, p_ee - o, dim=-1))
                cols_rot.append(z)
            else:
                cols_pos.append(z)
                cols_rot.append(torch.zeros_like(z))
        J = torch.cat([torch.stack(cols_pos, dim=-1), torch.stack(cols_rot, dim=-1)], dim=-2)
        return pose, J

    def clamp_to_joint_limits(self, q: torch.Tensor) -> torch.Tensor:
        self._check_q(q)
        c = self._constants(q.device, q.dtype)
        return torch.clamp(q, c["low"], c["high"])

    def joint_limits_exceeded(self, q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
        """(..., ndof) -> (...,) bool: any joint outside [low - eps, high + eps]
        (strict: a joint exactly at its limit is inside)."""
        self._check_q(q)
        c = self._constants(q.device, q.dtype)
        return torch.any((q < c["low"] - eps) | (q > c["high"] + eps), dim=-1)

    def sample_joint_angles(
        self, n: int, generator: torch.Generator, joint_limit_eps: float = 0.0, dtype=torch.float32
    ) -> torch.Tensor:
        """Uniform samples in [low + eps, high - eps] on the generator's device."""
        max_eps = 0.5 * float((self._limits_high - self._limits_low).min())
        if not 0.0 <= joint_limit_eps < max_eps:
            raise ValueError(
                f"joint_limit_eps={joint_limit_eps} must be in [0, {max_eps:.4f}) for {self.name} "
                "(half the narrowest joint range), else the sampling range inverts"
            )
        c = self._constants(generator.device, dtype)
        low = c["low"] + joint_limit_eps
        high = c["high"] - joint_limit_eps
        u = torch.rand((n, self._ndof), generator=generator, device=generator.device, dtype=dtype)
        return low + u * (high - low)

    def __repr__(self):
        return f"KinematicChain(name={self.name!r}, ndof={self.ndof})"
