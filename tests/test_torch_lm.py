"""Parity of the port's LM refinement with the JAX package: the unrolled
Cholesky, the pose residual, one LM step, and ``refine`` from the same seeds
without restarts (equal capture masks, q within 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu import lm as jlm
from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu_torch import lm as tlm
from ikflow_tpu_torch.robots import get_robot


def _configs(robot, rng, n, eps=0.05):
    low = np.array([lo for lo, _ in robot.actuated_joints_limits]) + eps
    high = np.array([hi for _, hi in robot.actuated_joints_limits]) - eps
    return (low + rng.uniform(size=(n, robot.ndof)) * (high - low)).astype(np.float32)


def _targets_and_seeds(name, seed, n=64, noise=0.15):
    rng = np.random.default_rng(seed)
    robot = get_robot(name)
    q_gt = _configs(robot, rng, n)
    targets = robot.forward_kinematics(torch.from_numpy(q_gt)).numpy()
    q0 = np.asarray(robot.clamp_to_joint_limits(
        torch.from_numpy(q_gt + rng.normal(scale=noise, size=q_gt.shape).astype(np.float32))))
    return targets, q0


def test_cholesky_solve_small_matches_jax():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(128, 7, 7)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(7, dtype=np.float32)
    b = rng.normal(size=(128, 7)).astype(np.float32)
    xt = tlm.cholesky_solve_small(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    xj = np.asarray(jlm.cholesky_solve_small(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(xt, xj, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", A, xt), b, atol=1e-3)


def test_pose_residual_matches_jax():
    targets, q0 = _targets_and_seeds("panda", 1)
    pose = get_robot("panda").forward_kinematics(torch.from_numpy(q0)).numpy()
    rt = tlm.pose_residual(torch.from_numpy(pose), torch.from_numpy(targets)).numpy()
    rj = np.asarray(jlm.pose_residual(jnp.asarray(pose), jnp.asarray(targets)))
    np.testing.assert_allclose(rt, rj, atol=1e-6, rtol=0)


# With the default damping 1e-4, J^T J + lambda I of a redundant arm has a
# condition number near 1e8, so a one-ulp difference (XLA contracts a - b*c
# into an FMA and takes an approximate sqrt inside jit; torch does neither)
# moves q by up to ~1e-3 rad along the null space, where the pose does not
# change. q is therefore held to 1e-5 at a damping of 0.1, where the solve is
# well conditioned; at the default damping the capture masks and the captured
# poses are held instead.


@pytest.mark.parametrize("name", ["panda", "fetch"])
def test_lm_step_matches_jax(name):
    targets, q0 = _targets_and_seeds(name, 2)
    qt = tlm.lm_step(get_robot(name), torch.from_numpy(q0), torch.from_numpy(targets), lambd=0.1).numpy()
    qj = np.asarray(jlm.lm_step(jax_get_robot(name), jnp.asarray(q0), jnp.asarray(targets), lambd=0.1))
    np.testing.assert_allclose(qt, qj, atol=1e-5, rtol=0)


REFINE_CASES = [("panda", 3), ("panda", 4), ("fetch", 5), ("rizon4", 6)]


def _refine_both(name, seed, lambd):
    targets, q0 = _targets_and_seeds(name, seed)
    kw = dict(n_steps=3, pos_tol=1e-3, rot_tol=0.01, lambd=lambd)
    t = tlm.refine(get_robot(name), torch.from_numpy(q0), torch.from_numpy(targets), **kw)
    j = jlm.refine(jax_get_robot(name), jnp.asarray(q0), jnp.asarray(targets), restart_key=None, **kw)
    return targets, [x.numpy() for x in t], [np.asarray(x) for x in j]


@pytest.mark.parametrize("name,seed", REFINE_CASES)
def test_refine_matches_jax(name, seed):
    _, (cq_t, cv_t, qf_t), (cq_j, cv_j, qf_j) = _refine_both(name, seed, lambd=0.1)
    np.testing.assert_array_equal(cv_t, cv_j)
    assert 0 < cv_t.sum() < len(cv_t)  # the masks hold both outcomes
    np.testing.assert_allclose(cq_t, cq_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(qf_t, qf_j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,seed", REFINE_CASES)
def test_refine_default_damping_matches_jax_masks_and_poses(name, seed):
    targets, (cq_t, cv_t, _), (cq_j, cv_j, _) = _refine_both(name, seed, lambd=1e-4)
    np.testing.assert_array_equal(cv_t, cv_j)
    # The null-space drift moves the captured pose by second-order amounts:
    # held to a tenth of the 1 mm tolerance.
    fk = get_robot(name).forward_kinematics
    pt, pj = fk(torch.tensor(cq_t))[cv_t], fk(torch.tensor(cq_j))[cv_t]
    np.testing.assert_allclose(pt[:, :3].numpy(), pj[:, :3].numpy(), atol=1e-4, rtol=0)
    ang = tlm.pose_residual(pt, pj)[:, 3:].norm(dim=-1)
    assert float(ang.max()) < 1e-3


def _boundary_optimum(robot, target):
    """Seed at the limit-constrained optimum of an unreachable target, where
    every further step is rejected."""
    q = robot.clamp_to_joint_limits(torch.zeros(1, robot.ndof))
    for _ in range(60):
        q = tlm.lm_step(robot, q, target, lambd=1e-2)
    return q


def test_restart_fires_at_restart_lambd_not_lambd_max():
    robot = get_robot("panda")
    target = torch.tensor([[0.0, 0.0, 100.0, 1.0, 0.0, 0.0, 0.0]])
    q_star = _boundary_optimum(robot, target)
    kw = dict(n_steps=1, pos_tol=1e-3, rot_tol=0.1, restart_generator=torch.Generator().manual_seed(7))
    # One rejected step from lam 0.7 -> 3.5 >= restart_lambd 3.0: a fresh draw.
    _, _, q_restarted = tlm.refine(robot, q_star, target, lambd=0.7, **kw)
    assert float((q_restarted - q_star).abs().max()) > 0.05
    # From lam 0.1 -> 0.5 < 3.0: no restart, the rejected pose stays put.
    _, _, q_kept = tlm.refine(robot, q_star, target, lambd=0.1, **kw)
    np.testing.assert_allclose(q_kept.numpy(), q_star.numpy(), atol=1e-6)
    # Without a generator there is never a restart.
    _, _, q_final = tlm.refine(robot, q_star, target, n_steps=1, pos_tol=1e-3, rot_tol=0.1, lambd=0.7)
    np.testing.assert_allclose(q_final.numpy(), q_star.numpy(), atol=1e-6)


def test_refine_captures_first_valid():
    robot = get_robot("panda")
    targets, q0 = _targets_and_seeds("panda", 8, n=128, noise=0.05)
    cap_q, cap_valid, _ = tlm.refine(robot, torch.from_numpy(q0), torch.from_numpy(targets), n_steps=8,
                                     pos_tol=1e-3, rot_tol=0.01)
    assert float(cap_valid.float().mean()) > 0.9
    pos = robot.forward_kinematics(cap_q)[cap_valid, :3] - torch.from_numpy(targets)[cap_valid, :3]
    assert float(pos.norm(dim=-1).max()) < 1e-3
