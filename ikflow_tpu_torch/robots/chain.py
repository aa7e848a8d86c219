"""Serial kinematic chains with batched forward kinematics and the analytic
Jacobian on torch tensors.

Port of ``ikflow_tpu/robots/chain.py`` (``_rollout``, FK, the geometric
Jacobian, joint-limit helpers, sampling with the optional self-collision
filter, and the capsule self-collision check with its host-calibrated pair
list).

The chain data is host numpy (float64); per device and dtype it is cast once
into constant tensors. The 3x3 products are written as broadcast
multiply-and-sum, so the rotation chain runs in true fp32 whatever the TF32
flags say. The collision pair list is built once per robot on the host in
float64, by the same calibration as the JAX package, so the two lists match.
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


@dataclasses.dataclass(frozen=True)
class Capsule:
    """Collision capsule attached to link frame ``frame_index`` (0 = base,
    i = frame after joint i); endpoints in that link's local frame."""

    frame_index: int
    p0: Tuple[float, float, float]
    p1: Tuple[float, float, float]
    radius: float


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as an elementwise sum: exact fp32."""
    return (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)


def _rot(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (3,) -> (..., 3)."""
    return (R * v).sum(-1)


class KinematicChain:
    """A serial chain. Every method follows the device and dtype of its input."""

    def __init__(
        self,
        name: str,
        joints: Sequence[Joint],
        capsules: Sequence[Capsule] = (),
        calibration_configs: Optional[Sequence[Sequence[float]]] = None,
    ):
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
        self.capsules = tuple(capsules)
        self._calibration_configs = (
            None if calibration_configs is None else [np.asarray(c, dtype=np.float64) for c in calibration_configs]
        )
        self._collision_pairs = self._build_collision_pairs()
        self._consts: Dict[Tuple[torch.device, torch.dtype], dict] = {}

    @property
    def ndof(self) -> int:
        return self._ndof

    @property
    def n_capsule_pairs(self) -> int:
        return len(self._collision_pairs)

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
                "cap_p0": [t(cap.p0) for cap in self.capsules],
                "cap_p1": [t(cap.p1) for cap in self.capsules],
            }
            if self._collision_pairs:
                ia = [a for a, _ in self._collision_pairs]
                ib = [b for _, b in self._collision_pairs]
                radii = np.array([cap.radius for cap in self.capsules])
                c["pair_a"] = torch.as_tensor(ia, dtype=torch.long, device=device)
                c["pair_b"] = torch.as_tensor(ib, dtype=torch.long, device=device)
                c["pair_rsum"] = t(radii[ia] + radii[ib])
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

    def fk_frames(self, q: torch.Tensor):
        """All link frames: q (..., ndof) -> (R (..., L, 3, 3), p (..., L, 3))."""
        frames, _, _ = self._rollout(q)
        return torch.stack([R for R, _ in frames], dim=-3), torch.stack([p for _, p in frames], dim=-2)

    def capsule_endpoints(self, q: torch.Tensor) -> torch.Tensor:
        """World-frame end points of every collision capsule: (..., ndof) ->
        (..., n_capsules, 2, 3), batched on the input's device."""
        self._check_q(q)
        c = self._constants(q.device, q.dtype)
        Rs, ps = self.fk_frames(q)
        ends = []
        for cap, p0, p1 in zip(self.capsules, c["cap_p0"], c["cap_p1"]):
            if cap.frame_index == 0:
                ends.append(torch.stack([p0, p1]).expand(q.shape[:-1] + (2, 3)))
            else:
                R, p = Rs[..., cap.frame_index - 1, :, :], ps[..., cap.frame_index - 1, :]
                ends.append(torch.stack([p + _rot(R, p0), p + _rot(R, p1)], dim=-2))
        return torch.stack(ends, dim=-3)

    def config_self_collides(self, q: torch.Tensor) -> torch.Tensor:
        """(..., ndof) -> (...,) bool: any calibrated capsule pair closer than
        the sum of its radii, batched on the input's device."""
        self._check_q(q)
        if not self._collision_pairs:
            return torch.zeros(q.shape[:-1], dtype=torch.bool, device=q.device)
        c = self._constants(q.device, q.dtype)
        ends = self.capsule_endpoints(q)
        A0, A1 = ends[..., 0, :], ends[..., 1, :]
        ia, ib = c["pair_a"], c["pair_b"]
        d = segment_segment_distance(A0[..., ia, :], A1[..., ia, :], A0[..., ib, :], A1[..., ib, :])
        return torch.any(d < c["pair_rsum"], dim=-1)

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

    def sample_joint_angles_and_poses(
        self,
        n: int,
        generator: torch.Generator,
        joint_limit_eps: float = 0.0,
        only_non_self_colliding: bool = False,
        oversample_factor: int = 2,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q, pose) pairs on the generator's device. With
        ``only_non_self_colliding``, draw ``n * oversample_factor`` configs and
        keep the first ``n`` collision-free ones (a stable argsort on the
        collision mask puts the colliding rows last); raise if fewer than
        ``n`` are collision-free."""
        if not only_non_self_colliding:
            q = self.sample_joint_angles(n, generator, joint_limit_eps)
            return q, self.forward_kinematics(q)
        m = n * oversample_factor
        q = self.sample_joint_angles(m, generator, joint_limit_eps)
        colliding = self.config_self_collides(q)
        n_clean = m - int(colliding.sum())
        if n_clean < n:
            raise ValueError(
                f"only {n_clean}/{m} oversampled configs are collision-free (need {n}); "
                f"raise oversample_factor (currently {oversample_factor})"
            )
        order = torch.sort(colliding.to(torch.uint8), stable=True).indices  # collision-free rows first
        q = q[order[:n]]
        return q, self.forward_kinematics(q)

    # ------------------------------------------------------------------
    # Host (numpy, float64) calibration of the collision pair list.
    # ------------------------------------------------------------------
    def _fk_frames_np(self, q: np.ndarray):
        """Float64 frames after each joint, for one configuration."""
        R = np.eye(3)
        p = np.zeros(3)
        frames = []
        qi = 0
        for idx, joint in enumerate(self.joints):
            p = p + R @ self._origins_t[idx]
            R = R @ self._origins_R[idx]
            if joint.joint_type == REVOLUTE:
                th = q[qi]
                R = R @ (np.eye(3) + np.sin(th) * self._K[idx] + (1 - np.cos(th)) * self._KK[idx])
                qi += 1
            elif joint.joint_type == PRISMATIC:
                p = p + q[qi] * (R @ self._axes[idx])
                qi += 1
            frames.append((R.copy(), p.copy()))
        return frames

    def _capsule_endpoints_np(self, q: np.ndarray):
        frames = self._fk_frames_np(q)
        pts = []
        for cap in self.capsules:
            R, p = (np.eye(3), np.zeros(3)) if cap.frame_index == 0 else frames[cap.frame_index - 1]
            pts.append((p + R @ np.asarray(cap.p0), p + R @ np.asarray(cap.p1)))
        return pts

    @staticmethod
    def _seg_seg_distance_np(p0, p1, q0, q1) -> float:
        """Smallest distance between 24 evenly spaced points on each segment."""
        ts = np.linspace(0.0, 1.0, 24)
        a = p0[None, :] + ts[:, None] * (p1 - p0)[None, :]
        b = q0[None, :] + ts[:, None] * (q1 - q0)[None, :]
        return float(np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1).min())

    def _build_collision_pairs(self, margin: float = 0.02):
        """Every capsule pair, less the pairs on the same or adjacent links
        and the pairs that come within ``rsum + margin`` in any calibration
        configuration (collision-free poses; by default the mid-limits centre
        and the clamped zero pose). The JAX package's explicit ignore list is
        empty for every robot and not ported."""
        if not self.capsules:
            return tuple()
        ref_configs = self._calibration_configs or [
            0.5 * (self._limits_low + self._limits_high),
            np.clip(np.zeros(self._ndof), self._limits_low, self._limits_high),
        ]
        ref_pts = [self._capsule_endpoints_np(qc) for qc in ref_configs]
        pairs = []
        for a in range(len(self.capsules)):
            for b in range(a + 1, len(self.capsules)):
                if abs(self.capsules[a].frame_index - self.capsules[b].frame_index) <= 1:
                    continue
                rsum = self.capsules[a].radius + self.capsules[b].radius
                d = min(self._seg_seg_distance_np(pts[a][0], pts[a][1], pts[b][0], pts[b][1]) for pts in ref_pts)
                if d >= rsum + margin:
                    pairs.append((a, b))
        return tuple(pairs)

    def __repr__(self):
        return f"KinematicChain(name={self.name!r}, ndof={self.ndof})"


def segment_segment_distance(p0: torch.Tensor, p1: torch.Tensor, q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Smallest distance between segments [p0, p1] and [q0, q1], batched over
    (..., 3): the clamped closest-point parameterisation (Ericson, Real-Time
    Collision Detection 5.1.9), branch-free."""
    d1, d2, r = p1 - p0, q1 - q0, p0 - q0
    a = (d1 * d1).sum(-1)
    e = (d2 * d2).sum(-1)
    f = (d2 * r).sum(-1)
    c = (d1 * r).sum(-1)
    b = (d1 * d2).sum(-1)
    denom = a * e - b * b
    s = torch.where(denom > 1e-12, (b * f - c * e) / torch.clamp(denom, min=1e-12), torch.zeros_like(denom))
    s = torch.clamp(s, 0.0, 1.0)
    t = torch.where(e > 1e-12, (b * s + f) / torch.clamp(e, min=1e-12), torch.zeros_like(e))
    t_cl = torch.clamp(t, 0.0, 1.0)
    s_re = torch.where(a > 1e-12, (t_cl * b - c) / torch.clamp(a, min=1e-12), torch.zeros_like(a))
    s = torch.where((t != t_cl) | (e <= 1e-12), torch.clamp(s_re, 0.0, 1.0), s)
    return torch.linalg.norm(p0 + s[..., None] * d1 - (q0 + t_cl[..., None] * d2), dim=-1)
