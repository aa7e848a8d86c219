"""Batched damped Levenberg-Marquardt IK refinement on torch tensors.

Port of ``ikflow_tpu/lm.py``. The normal equations are formed as broadcast
multiply-and-sum, so they run in true fp32 whatever the TF32 flags say.
"""

from __future__ import annotations

from typing import Optional

import torch

from ikflow_tpu_torch.evaluation import solution_pose_errors
from ikflow_tpu_torch.math.quaternion import quat_conjugate, quat_log_map, quat_mul


def cholesky_solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD systems A x = b for small d, batched over the leading axis,
    with the d-loops unrolled: Cholesky (pivots clamped at 1e-12), then
    forward and back substitution. A: (n, d, d); b: (n, d)."""
    d = A.shape[-1]
    L = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * d
    for i in range(d):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * d
    for i in reversed(range(d)):
        s = y[i]
        for k in range(i + 1, d):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def pose_residual(pose: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """6-D residual [dp; omega]: dp = p_target - p, omega the world-frame
    rotation vector taking the realized orientation onto the target."""
    dp = target[..., :3] - pose[..., :3]
    omega = quat_log_map(quat_mul(target[..., 3:], quat_conjugate(pose[..., 3:])))
    return torch.cat([dp, omega], dim=-1)


def config_pose_errors(robot, q: torch.Tensor, target_poses: torch.Tensor):
    """(position L2 error, geodesic rotation error) of each configuration's
    FK against its target: ``evaluation.solution_pose_errors``, named apart
    from ``evaluation.pose_errors``, which compares two pose arrays."""
    return solution_pose_errors(robot, q, target_poses)


def _normal_equations(J: torch.Tensor, r: torch.Tensor):
    """J^T J (n, d, d) and J^T r (n, d) in exact fp32."""
    JtJ = (J.unsqueeze(-1) * J.unsqueeze(-2)).sum(dim=-3)
    Jtr = (J * r.unsqueeze(-1)).sum(dim=-2)
    return JtJ, Jtr


def lm_step(robot, q: torch.Tensor, target_poses: torch.Tensor, lambd: float = 1e-4,
            clamp_to_limits: bool = True) -> torch.Tensor:
    """One damped LM step per pose: solve (J^T J + lambd I) dq = J^T r."""
    pose, J = robot.fk_pose_and_jacobian(q)
    JtJ, Jtr = _normal_equations(J, pose_residual(pose, target_poses))
    JtJ = JtJ + lambd * torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    q_new = q + cholesky_solve_small(JtJ, Jtr)
    if clamp_to_limits:
        q_new = robot.clamp_to_joint_limits(q_new)
    return q_new


def _valid(r: torch.Tensor, pos_tol: float, rot_tol: float) -> torch.Tensor:
    return (torch.linalg.norm(r[:, :3], dim=-1) < pos_tol) & (torch.linalg.norm(r[:, 3:], dim=-1) < rot_tol)


def refine(
    robot,
    q0: torch.Tensor,
    target_poses: torch.Tensor,
    n_steps: int,
    pos_tol: float,
    rot_tol: float,
    lambd: float = 1e-4,
    clamp_to_limits: bool = True,
    lambd_min: float = 1e-8,
    lambd_max: float = 1e3,
    lambd_down: float = 0.333,
    lambd_up: float = 5.0,
    restart_generator: Optional[torch.Generator] = None,
    restart_lambd: float = 3.0,
    restart_noise: Optional[torch.Tensor] = None,
):
    """Adaptive-damping LM with first-valid-wins capture, fixed shapes.

    Every pose runs all ``n_steps``; a mask keeps the first q found within
    tolerance. A step is accepted only if it lowers the squared residual
    (damping x ``lambd_down``), else rejected (x ``lambd_up``). With limits,
    a DOF pinned at a limit whose descent points outward is frozen out of
    the solve. With ``restart_generator``, a still-invalid pose whose damping
    reaches ``restart_lambd`` on a rejected step is redrawn uniformly within
    the limits; step i draws ``rand(q.shape)``, or takes ``restart_noise[i]``
    when given, (n_steps, n, ndof) drawn ahead (a shard's rows of a draw
    made over the whole batch). Returns (captured_q, captured_valid, q_final).
    """
    n, ndof = q0.shape
    eye = torch.eye(ndof, dtype=q0.dtype, device=q0.device)
    low = robot.limits_low(q0.device, q0.dtype)
    high = robot.limits_high(q0.device, q0.dtype)

    q = q0
    lam = torch.full((n,), lambd, dtype=q0.dtype, device=q0.device)
    cap_q = q0
    cap_valid = torch.zeros((n,), dtype=torch.bool, device=q0.device)
    for step in range(n_steps):
        pose, J = robot.fk_pose_and_jacobian(q)
        r = pose_residual(pose, target_poses)
        valid = _valid(r, pos_tol, rot_tol)
        cap_q = torch.where((valid & ~cap_valid)[:, None], q, cap_q)
        cap_valid = cap_valid | valid

        err = torch.sum(r * r, dim=-1)
        JtJ, Jtr = _normal_equations(J, r)
        JtJ = JtJ + lam[:, None, None] * eye
        if clamp_to_limits:
            pinned_out = ((q <= low + 1e-6) & (Jtr < 0)) | ((q >= high - 1e-6) & (Jtr > 0))
            free = (~pinned_out).to(q.dtype)
            JtJ = JtJ * (free[:, :, None] * free[:, None, :]) + (1.0 - free)[:, :, None] * eye
            Jtr = Jtr * free
        q_try = q + cholesky_solve_small(JtJ, Jtr)
        if clamp_to_limits:
            q_try = torch.clamp(q_try, low, high)
        r_try = pose_residual(robot.forward_kinematics(q_try), target_poses)
        improved = torch.sum(r_try * r_try, dim=-1) < err
        q_next = torch.where(improved[:, None], q_try, q)
        lam_next = torch.where(improved, torch.clamp(lam * lambd_down, min=lambd_min),
                               torch.clamp(lam * lambd_up, max=lambd_max))
        if restart_generator is not None or restart_noise is not None:
            stuck = (lam_next >= restart_lambd) & ~cap_valid & ~improved
            if restart_noise is None:
                u = torch.rand(q.shape, generator=restart_generator, device=q.device, dtype=q.dtype)
            else:
                u = restart_noise[step]
            q_next = torch.where(stuck[:, None], u * (high - low) + low, q_next)
            lam_next = torch.where(stuck, torch.full_like(lam_next, lambd), lam_next)
        q, lam = q_next, lam_next

    # The last step may have converged: one final check.
    valid = _valid(pose_residual(robot.forward_kinematics(q), target_poses), pos_tol, rot_tol)
    cap_q = torch.where((valid & ~cap_valid)[:, None], q, cap_q)
    return cap_q, cap_valid | valid, q
