"""Solution grading: pose errors and joint-limit violations.

Port of ``ikflow_tpu/evaluation.py`` without the self-collision check, which
is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ikflow_tpu_torch.math.quaternion import geodesic_distance


class SolutionEvaluation(NamedTuple):
    pos_errors: torch.Tensor  # (n,) L2 position error [m]
    rot_errors: torch.Tensor  # (n,) geodesic rotation error [rad]
    joint_limits_exceeded: torch.Tensor  # (n,) bool


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


def evaluate_solutions(robot, target_poses: torch.Tensor, solutions: torch.Tensor) -> SolutionEvaluation:
    l2, ang = solution_pose_errors(robot, solutions, target_poses)
    return SolutionEvaluation(l2, ang, calculate_joint_limits_exceeded(robot, solutions))
