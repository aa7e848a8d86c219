"""Solution grading: pose errors, joint-limit violations, self-collisions.

Port of ``ikflow_tpu/evaluation.py`` (with ``solution_diversity``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ikflow_tpu_torch.math.quaternion import geodesic_distance


class SolutionEvaluation(NamedTuple):
    pos_errors: torch.Tensor  # (n,) L2 position error [m]
    rot_errors: torch.Tensor  # (n,) geodesic rotation error [rad]
    joint_limits_exceeded: torch.Tensor  # (n,) bool
    self_colliding: torch.Tensor  # (n,) bool


def pose_errors(poses_1: torch.Tensor, poses_2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2 position error and geodesic rotation error between pose batches."""
    l2 = torch.linalg.norm(poses_1[..., :3] - poses_2[..., :3], dim=-1)
    return l2, geodesic_distance(poses_1[..., 3:], poses_2[..., 3:])


def solution_pose_errors(robot, solutions: torch.Tensor, target_poses: torch.Tensor):
    """FK-grade solutions against one (7,) target pose or (n, 7) targets."""
    if target_poses.ndim == 1:
        target_poses = target_poses.expand(solutions.shape[0], 7)
    return pose_errors(robot.forward_kinematics(solutions), target_poses)


def calculate_joint_limits_exceeded(robot, configs: torch.Tensor) -> torch.Tensor:
    """Per-config bool: any joint strictly outside its limits."""
    return robot.joint_limits_exceeded(configs)


def calculate_self_collisions(robot, configs: torch.Tensor) -> torch.Tensor:
    """Per-config bool: any calibrated capsule pair in contact."""
    return robot.config_self_collides(configs)


def solution_diversity(solutions: torch.Tensor, n_poses: int, n_samples: int) -> torch.Tensor:
    """Per-pose solution spread: mean pairwise joint-space L2 distance (rad).
    ``solutions`` is (n_poses * n_samples, ndof), pose-major; returns
    (n_poses,), the mean over the n_samples * (n_samples - 1) ordered pairs."""
    if n_samples < 2:
        raise ValueError("diversity needs at least 2 samples per pose")
    sols = solutions.reshape(n_poses, n_samples, solutions.shape[-1])
    d = torch.linalg.norm(sols[:, :, None, :] - sols[:, None, :, :], dim=-1)
    return d.sum(dim=(1, 2)) / (n_samples * (n_samples - 1))


def evaluate_solutions(robot, target_poses: torch.Tensor, solutions: torch.Tensor) -> SolutionEvaluation:
    l2, ang = solution_pose_errors(robot, solutions, target_poses)
    return SolutionEvaluation(l2, ang, calculate_joint_limits_exceeded(robot, solutions),
                              calculate_self_collisions(robot, solutions))
