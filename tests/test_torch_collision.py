"""Parity of the port's self-collision check with the JAX package: capsule
tables, the host-calibrated pair list, link frames, the batched segment
distance, ``config_self_collides`` on uniform samples, and the fifth field of
the solver's detailed output. Configurations come from numpy seeds."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu.robots.chain import _segment_segment_distance as jax_segment_segment_distance
from ikflow_tpu_torch.evaluation import calculate_self_collisions, evaluate_solutions
from ikflow_tpu_torch.robots import get_robot, robot_names
from ikflow_tpu_torch.robots.chain import segment_segment_distance

# Uniform in-limit samples per robot: 4096 for Panda, the serving robot, 1024 for the others.
N_SAMPLES = {"panda": 4096, "fetch": 1024, "fetch_arm": 1024, "rizon4": 1024}


def _uniform(robot, n, seed):
    rng = np.random.default_rng(seed)
    low = np.array([lo for lo, _ in robot.actuated_joints_limits])
    high = np.array([hi for _, hi in robot.actuated_joints_limits])
    return (low + rng.uniform(size=(n, robot.ndof)) * (high - low)).astype(np.float32)


@pytest.mark.parametrize("name", robot_names())
def test_capsules_and_pair_list_equal_to_jax(name):
    tr, jr = get_robot(name), jax_get_robot(name)
    assert [dataclasses.astuple(c) for c in tr.capsules] == [dataclasses.astuple(c) for c in jr.capsules]
    assert tr._collision_pairs == jr._collision_pairs
    assert tr.n_capsule_pairs == jr.n_capsule_pairs > 0


@pytest.mark.parametrize("name", robot_names())
def test_fk_frames_match_jax(name):
    q = _uniform(get_robot(name), 64, seed=0)
    R_t, p_t = get_robot(name).fk_frames(torch.from_numpy(q))
    R_j, p_j = jax_get_robot(name).fk_frames(jnp.asarray(q))
    assert R_t.shape == R_j.shape and p_t.shape == p_j.shape
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-5, rtol=0)


def test_segment_segment_distance_matches_jax():
    """Random segments, plus parallel, degenerate (point) and crossing ones."""
    rng = np.random.default_rng(1)
    seg = rng.normal(scale=0.3, size=(4, 512, 3)).astype(np.float32)
    seg[1, :32] = seg[0, :32] + np.float32(0.5) * (seg[1, :32] - seg[0, :32])  # p1 on the p0 ray
    seg[3, 32:64] = seg[2, 32:64] + (seg[1, 32:64] - seg[0, 32:64])  # parallel
    seg[1, 64:96] = seg[0, 64:96]  # first segment a point
    seg[3, 96:128] = seg[2, 96:128]  # second segment a point
    d_t = segment_segment_distance(*[torch.from_numpy(s) for s in seg])
    d_j = jax_segment_segment_distance(*[jnp.asarray(s) for s in seg])
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", robot_names())
def test_config_self_collides_matches_jax(name):
    tr, jr = get_robot(name), jax_get_robot(name)
    q = _uniform(tr, N_SAMPLES[name], seed=2)
    flags_t = tr.config_self_collides(torch.from_numpy(q))
    flags_j = np.asarray(jr.config_self_collides(jnp.asarray(q)))
    assert flags_t.dtype == torch.bool and flags_t.shape == (q.shape[0],)
    np.testing.assert_array_equal(flags_t.numpy(), flags_j)
    assert 0 < int(flags_j.sum()) < q.shape[0]  # the samples hold both outcomes
    np.testing.assert_array_equal(calculate_self_collisions(tr, torch.from_numpy(q)).numpy(), flags_j)


def test_panda_ready_pose_is_free_and_clamped_zero_collides():
    robot = get_robot("panda")
    ready = torch.tensor([[0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785]])
    zero = robot.clamp_to_joint_limits(torch.zeros(1, 7))
    assert not bool(robot.config_self_collides(ready)[0])
    assert bool(robot.config_self_collides(zero)[0])
    assert robot.config_self_collides(torch.zeros(2, 3, 7)).shape == (2, 3)
    with pytest.raises(ValueError):
        robot.config_self_collides(torch.zeros(2, 6))


def test_evaluate_solutions_has_self_colliding():
    robot = get_robot("panda")
    q = torch.from_numpy(_uniform(robot, 256, seed=3))
    ev = evaluate_solutions(robot, robot.forward_kinematics(q), q)
    assert ev._fields == ("pos_errors", "rot_errors", "joint_limits_exceeded", "self_colliding")
    assert torch.equal(ev.self_colliding, robot.config_self_collides(q))
    assert float(ev.pos_errors.max()) < 1e-6
