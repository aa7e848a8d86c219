"""Every shipped deploy artifact (``models/*.npz``, the eight registered
architectures) loads through the port's registry and its inverse matches the
JAX package's on the same latents and poses. Slow: eight full-width flows in
both packages.

atol 3e-4, as for panda__full__sigmoid in ``tests/test_torch_solver.py``:
fp32 sums over K = 1024 in another order compound through up to 32 subnets
and the couplings' exp."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu import registry as jax_registry
from ikflow_tpu_torch import registry

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("name", registry.get_all_model_names())
def test_shipped_artifact_inverse_matches_jax(name):
    entry = registry.model_descriptions()[name]
    if not os.path.exists(registry.resolve_weights_path(entry)):
        pytest.skip(f"{entry['weights_path']} is not in the model search path")
    ts, thp = registry.get_ik_solver(name, device="cpu")
    js, jhp = jax_registry.get_ik_solver(name)
    assert thp.to_dict() == jhp.to_dict() and ts.conditional_size == js.conditional_size
    robot = ts.robot
    poses = robot.forward_kinematics(robot.sample_joint_angles(64, torch.Generator().manual_seed(8),
                                                               joint_limit_eps=0.02)).numpy()
    latent = np.random.default_rng(0).normal(size=(64, ts.network_width)).astype(np.float32)
    qt = ts.generate_ik_solutions(poses, latent=torch.from_numpy(0.75 * latent), clamp_to_joint_limits=False)
    qj = js.generate_ik_solutions(jnp.asarray(poses), latent=jnp.asarray(0.75 * latent), clamp_to_joint_limits=False)
    assert qt.shape == (64, robot.ndof)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=3e-4, rtol=0)
