"""The small public names of the port's modules against the JAX package's:
the registry's model list, the lazy top-level names, the solver's
properties, the pose-error helpers, the quaternion and SO(3) helpers and the
flow's parameter count. Inputs from numpy seeds; tolerance 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ikflow_tpu
import ikflow_tpu_torch
from ikflow_tpu import evaluation as jax_evaluation
from ikflow_tpu import lm as jax_lm
from ikflow_tpu import registry as jax_registry
from ikflow_tpu.math import quaternion as jax_quat
from ikflow_tpu.math import so3 as jax_so3
from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu_torch import evaluation, lm, registry
from ikflow_tpu_torch.math import quaternion, so3
from ikflow_tpu_torch.robots import get_robot
from test_torch_solver import _solver_pair

ATOL = 1e-6


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_get_all_model_names_matches_jax():
    assert registry.get_all_model_names() == jax_registry.get_all_model_names()
    assert len(registry.get_all_model_names()) == 8


@pytest.mark.parametrize("name", ["IKFlowSolver", "FlowHyperParams", "get_robot", "get_ik_solver",
                                  "get_all_model_names"])
def test_lazy_top_level_names(name):
    assert callable(getattr(ikflow_tpu, name)) and callable(getattr(ikflow_tpu_torch, name))
    assert getattr(ikflow_tpu_torch, name).__module__.startswith("ikflow_tpu_torch.")
    with pytest.raises(AttributeError):
        getattr(ikflow_tpu_torch, "no_such_name")
    assert ikflow_tpu_torch.__version__ == ikflow_tpu.__version__


@pytest.mark.parametrize("sigmoid", [False, True])
def test_solver_properties_match_jax(sigmoid):
    js, ts = _solver_pair(sigmoid)
    assert ts.conditional_size == js.conditional_size == (7 if sigmoid else 8)
    assert ts.hyper_parameters.to_dict() == js.hyper_parameters.to_dict()
    assert ts.flow.n_params(ts.params) == js.flow.n_params(js.params)


def test_pose_errors_cm_deg_and_config_pose_errors_match_jax():
    rng = np.random.default_rng(0)
    p1 = np.concatenate([rng.normal(size=(32, 3)), _unit_quats(rng, 32)], axis=1).astype(np.float32)
    p2 = np.concatenate([rng.normal(size=(32, 3)), _unit_quats(rng, 32)], axis=1).astype(np.float32)
    for t, j in zip(evaluation.pose_errors_cm_deg(torch.from_numpy(p1), torch.from_numpy(p2)),
                    jax_evaluation.pose_errors_cm_deg(jnp.asarray(p1), jnp.asarray(p2))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=ATOL, atol=ATOL)  # 1e-6 relative: degrees reach 180
    robot, jrobot = get_robot("panda"), jax_get_robot("panda")
    q = robot.sample_joint_angles(32, torch.Generator().manual_seed(1))
    for target in (torch.from_numpy(p1), torch.from_numpy(p1[0])):
        out_t = lm.config_pose_errors(robot, q, target)
        out_j = jax_lm.config_pose_errors(jrobot, jnp.asarray(q.numpy()), jnp.asarray(target.numpy()))
        for t, j in zip(out_t, out_j):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(1)
    q = _unit_quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(quaternion.quat_rotate(torch.from_numpy(q), torch.from_numpy(v)).numpy(),
                               np.asarray(jax_quat.quat_rotate(jnp.asarray(q), jnp.asarray(v))), atol=ATOL)
    np.testing.assert_allclose(quaternion.quat_to_matrix(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_quat.quat_to_matrix(jnp.asarray(q))), atol=ATOL)
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(-np.pi, np.pi, size=64).astype(np.float32)
    np.testing.assert_allclose(
        quaternion.quat_from_axis_angle(torch.from_numpy(axis), torch.from_numpy(angle)).numpy(),
        np.asarray(jax_quat.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle))), atol=ATOL)
    # one quaternion rotating many vectors broadcasts as in JAX
    np.testing.assert_allclose(quaternion.quat_rotate(torch.from_numpy(q[0]), torch.from_numpy(v)).numpy(),
                               np.asarray(jax_quat.quat_rotate(jnp.asarray(q[0]), jnp.asarray(v))), atol=ATOL)


def test_so3_helpers_match_jax():
    rng = np.random.default_rng(2)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = so3.skew_np(axis).astype(np.float32)
    KK = K @ K
    theta = rng.uniform(-np.pi, np.pi, size=(5, 8)).astype(np.float32)
    R_t = so3.axis_angle_to_matrix(torch.from_numpy(K), torch.from_numpy(KK), torch.from_numpy(theta))
    R_j = jax_so3.axis_angle_to_matrix(jnp.asarray(K), jnp.asarray(KK), jnp.asarray(theta))
    assert R_t.shape == (5, 8, 3, 3)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=ATOL)
    np.testing.assert_allclose(so3.rotation_log(R_t).numpy(), np.asarray(jax_so3.rotation_log(R_j)), atol=ATOL)
    # the log inverts Rodrigues away from pi
    small = np.clip(theta, -3.0, 3.0)
    R_s = so3.axis_angle_to_matrix(torch.from_numpy(K), torch.from_numpy(KK), torch.from_numpy(small))
    np.testing.assert_allclose(so3.rotation_log(R_s).numpy(), small[..., None] * axis.astype(np.float32), atol=2e-4)
