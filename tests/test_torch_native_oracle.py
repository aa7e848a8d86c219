"""The port's float64 FK oracle (``robots/native_oracle.py``, built from the
repo's ``native/fk_oracle.cpp`` into ``build/``) against the JAX package's
wrapper of the same source, and the port's FK and Jacobian against it.
Skips only where there is no ``g++``."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu.robots import native_oracle as jax_native
from ikflow_tpu_torch.robots import get_robot, robot_names
from ikflow_tpu_torch.robots import native_oracle

ROBOTS = robot_names()


@pytest.fixture(scope="module")
def oracles():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the float64 oracle cannot be built")
    assert native_oracle.native_available()
    return {name: native_oracle.NativeFkOracle(get_robot(name)) for name in ROBOTS}


def _q(name, n, seed, eps=0.0):
    return get_robot(name).sample_joint_angles(n, torch.Generator().manual_seed(seed), joint_limit_eps=eps,
                                               dtype=torch.float64).numpy()


def test_builds_into_build_not_native(oracles):
    assert native_oracle.LIB_PATH.endswith("build/libfk_oracle.so")
    assert native_oracle.SOURCE.endswith("native/fk_oracle.cpp")


def test_golden_pose_float64(oracles):
    pose = oracles["panda"].forward_kinematics(np.zeros((1, 7)))[0]
    golden = np.array([0.088, 0.0, 0.926, 0.0, 0.92387953, 0.38268343, 0.0])
    np.testing.assert_allclose(pose[:3], golden[:3], atol=1e-9)
    assert min(np.abs(pose[3:] - golden[3:]).max(), np.abs(pose[3:] + golden[3:]).max()) < 1e-8


@pytest.mark.parametrize("name", ROBOTS)
def test_port_fk_and_jacobian_match_the_oracle(oracles, name):
    """The port's fp32 FK and Jacobian on the CPU within 5e-6 of float64."""
    robot = get_robot(name)
    q = _q(name, 512, 0)
    pose64, jac64 = oracles[name].fk_pose_and_jacobian(q)
    pose, jac = robot.fk_pose_and_jacobian(torch.from_numpy(q).float())
    pose, jac = pose.double().numpy(), jac.double().numpy()
    np.testing.assert_allclose(pose[:, :3], pose64[:, :3], atol=5e-6)
    dq = np.minimum(np.abs(pose[:, 3:] - pose64[:, 3:]).max(1), np.abs(pose[:, 3:] + pose64[:, 3:]).max(1))
    assert dq.max() < 5e-6
    np.testing.assert_allclose(jac, jac64, atol=5e-6)
    np.testing.assert_array_equal(oracles[name].forward_kinematics(q), pose64)


@pytest.mark.parametrize("name", ROBOTS)
def test_wrapper_matches_jax_wrapper(oracles, name):
    """Both packages' wrappers of the one source give the same float64 poses,
    Jacobians and LM solutions on the same inputs."""
    if not jax_native.native_available():
        pytest.skip("the JAX package's oracle did not build")
    jax_oracle = jax_native.NativeFkOracle(jax_get_robot(name))
    q = _q(name, 256, 1)
    np.testing.assert_array_equal(oracles[name].forward_kinematics(q), jax_oracle.forward_kinematics(q))
    for a, b in zip(oracles[name].fk_pose_and_jacobian(q), jax_oracle.fk_pose_and_jacobian(q)):
        np.testing.assert_array_equal(a, b)
    targets = oracles[name].forward_kinematics(q)
    q0 = q + 0.05 * np.random.default_rng(2).standard_normal(q.shape)
    for clamp in (True, False):
        qs_t, v_t = oracles[name].ik_lm(targets, q0, max_iters=15, clamp_to_limits=clamp)
        qs_j, v_j = jax_oracle.ik_lm(targets, q0, max_iters=15, clamp_to_limits=clamp)
        np.testing.assert_allclose(qs_t, qs_j, atol=1e-12)
        np.testing.assert_array_equal(v_t, v_j)


def test_lm_converges_inside_limits_and_refuses_bad_shapes(oracles):
    robot, oracle = get_robot("panda"), oracles["panda"]
    q_true = _q("panda", 200, 3, eps=0.05)
    targets = oracle.forward_kinematics(q_true)
    qs, valid = oracle.ik_lm(targets, q_true + 0.05 * np.random.default_rng(0).standard_normal(q_true.shape),
                             max_iters=15)
    assert valid.mean() > 0.98
    assert (qs >= robot._limits_low - 1e-9).all() and (qs <= robot._limits_high + 1e-9).all()
    _, unreachable = oracle.ik_lm(np.tile([[5.0, 5.0, 5.0, 1.0, 0, 0, 0]], (4, 1)), np.zeros((4, 7)), max_iters=10)
    assert not unreachable.any()
    with pytest.raises(ValueError):
        oracle.forward_kinematics(np.zeros((2, 6)))
    with pytest.raises(ValueError):
        oracle.ik_lm(targets[:3], q_true)


def test_jax_fk_agrees_through_the_port_oracle(oracles):
    """Closes the triangle: JAX's FK, the port's FK and the oracle on one
    draw of each robot."""
    for name in ROBOTS:
        q = _q(name, 64, 4)
        xla = np.asarray(jax_get_robot(name).forward_kinematics(jnp.asarray(q, dtype=jnp.float32)))
        nat = oracles[name].forward_kinematics(q)
        np.testing.assert_allclose(xla[:, :3], nat[:, :3], atol=5e-6)
