"""Parity of the port's robot layer with the JAX package: joint tables, FK and
the analytic Jacobian for all four robots (Fetch's prismatic torso included),
limits and sampling. FK/Jacobian tolerance atol 1e-5 (fp32, sums in another
order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu_torch.robots import get_robot, robot_names

ROBOTS = ["panda", "fetch", "fetch_arm", "rizon4"]


def _configs(robot, seed, n=64):
    rng = np.random.default_rng(seed)
    low = np.array([lo for lo, _ in robot.actuated_joints_limits])
    high = np.array([hi for _, hi in robot.actuated_joints_limits])
    return (low + rng.uniform(size=(n, robot.ndof)) * (high - low)).astype(np.float32)


def test_robot_names_match():
    from ikflow_tpu.robots import robot_names as jax_robot_names

    assert robot_names() == jax_robot_names()


@pytest.mark.parametrize("name", ROBOTS)
def test_joint_tables_equal(name):
    tj = [dataclasses.astuple(j) for j in get_robot(name).joints]
    jj = [dataclasses.astuple(j) for j in jax_get_robot(name).joints]
    assert tj == jj
    assert get_robot(name).actuated_joints_limits == jax_get_robot(name).actuated_joints_limits


@pytest.mark.parametrize("name", ROBOTS)
def test_fk_matches_jax(name):
    q = _configs(get_robot(name), seed=0)
    pose_t = get_robot(name).forward_kinematics(torch.from_numpy(q))
    pose_j = jax_get_robot(name).forward_kinematics(jnp.asarray(q))
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ROBOTS)
def test_jacobian_matches_jax(name):
    q = _configs(get_robot(name), seed=1)
    pose_t, J_t = get_robot(name).fk_pose_and_jacobian(torch.from_numpy(q))
    pose_j, J_j = jax_get_robot(name).fk_pose_and_jacobian(jnp.asarray(q))
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), atol=1e-5, rtol=0)


def test_fetch_torso_is_prismatic():
    """The torso column is the world z axis for position and zero for rotation."""
    q = torch.from_numpy(_configs(get_robot("fetch"), seed=2, n=4))
    _, J = get_robot("fetch").fk_pose_and_jacobian(q)
    np.testing.assert_allclose(J[:, :3, 0].numpy(), np.tile([0.0, 0.0, 1.0], (4, 1)), atol=1e-6)
    np.testing.assert_allclose(J[:, 3:, 0].numpy(), 0.0, atol=0)


def test_panda_zero_config_golden_pose():
    pose = get_robot("panda").forward_kinematics(torch.zeros(1, 7))[0].numpy()
    golden = np.array([0.088, 0.0, 0.926, 0.0, 0.92387953, 0.38268343, 0.0])
    np.testing.assert_allclose(pose[:3], golden[:3], atol=1e-5)
    assert min(np.abs(pose[3:] - golden[3:]).max(), np.abs(pose[3:] + golden[3:]).max()) < 1e-5


@pytest.mark.parametrize("name", ROBOTS)
def test_limits_clamp_and_exceeded_match_jax(name):
    rng = np.random.default_rng(3)
    q = (rng.normal(size=(128, get_robot(name).ndof)) * 3.0).astype(np.float32)
    tr, jr = get_robot(name), jax_get_robot(name)
    np.testing.assert_array_equal(tr.clamp_to_joint_limits(torch.from_numpy(q)).numpy(),
                                  np.asarray(jr.clamp_to_joint_limits(jnp.asarray(q))))
    for eps in (0.0, 0.1):
        np.testing.assert_array_equal(tr.joint_limits_exceeded(torch.from_numpy(q), eps).numpy(),
                                      np.asarray(jr.joint_limits_exceeded(jnp.asarray(q), eps)))


def test_sample_joint_angles_in_range_and_seeded():
    robot = get_robot("panda")
    q1 = robot.sample_joint_angles(500, torch.Generator().manual_seed(0), joint_limit_eps=0.02)
    q2 = robot.sample_joint_angles(500, torch.Generator().manual_seed(0), joint_limit_eps=0.02)
    assert q1.shape == (500, 7) and torch.equal(q1, q2)
    assert bool((q1 >= robot.limits_low() + 0.02 - 1e-6).all() and (q1 <= robot.limits_high() - 0.02 + 1e-6).all())
    with pytest.raises(ValueError):
        robot.sample_joint_angles(4, torch.Generator(), joint_limit_eps=10.0)


def test_wrong_q_width_raises():
    with pytest.raises(ValueError):
        get_robot("panda").forward_kinematics(torch.zeros(2, 6))
    with pytest.raises(ValueError):
        get_robot("nope")
