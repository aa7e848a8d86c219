"""Parity of the port's quaternion and SO(3) helpers with the JAX package.

Inputs come from seeded numpy and go through both; tolerance atol 1e-6 (fp32
arithmetic in the same order, different libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.math import quaternion as jq
from ikflow_tpu.math import so3 as jso3
from ikflow_tpu_torch.math import quaternion as tq
from ikflow_tpu_torch.math import so3 as tso3

ATOL = 1e-6


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotations(rng, n):
    """Random rotations plus the identity and the half-turns, where Shepperd's
    pivot choice matters most."""
    R = np.asarray(jq.quat_to_matrix(jnp.asarray(_unit_quats(rng, n))))
    special = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
                        np.diag([-1.0, -1.0, 1.0])]).astype(np.float32)
    return np.concatenate([R, special])


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_quat_mul_and_conjugate(seed):
    rng = np.random.default_rng(seed)
    a, b = _unit_quats(rng, 256), _unit_quats(rng, 256)
    _close(tq.quat_mul(torch.from_numpy(a), torch.from_numpy(b)), jq.quat_mul(a, b))
    _close(tq.quat_conjugate(torch.from_numpy(a)), jq.quat_conjugate(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_quat_from_matrix(seed):
    R = _rotations(np.random.default_rng(seed), 256)
    q = tq.quat_from_matrix(torch.from_numpy(R))
    _close(q, jq.quat_from_matrix(R))
    assert bool((q[:, 0] >= 0).all())


def test_geodesic_distance():
    rng = np.random.default_rng(2)
    a, b = _unit_quats(rng, 256), _unit_quats(rng, 256)
    b[:8] = a[:8]  # identical pairs hit the 1 - 1e-7 clip
    b[8:16] = -a[8:16]  # sign-flipped pairs are the same rotation
    _close(tq.geodesic_distance(torch.from_numpy(a), torch.from_numpy(b)), jq.geodesic_distance(a, b), atol=1e-5)
    x = torch.tensor([[1.0, 0, 0, 0]])
    y = torch.tensor([[0.0, 1, 0, 0]])
    assert abs(float(tq.geodesic_distance(x, y)[0]) - np.pi) < 1e-3


def test_quat_log_map():
    rng = np.random.default_rng(3)
    q = _unit_quats(rng, 256)
    q[:4] = [1.0, 0.0, 0.0, 0.0]  # identity: small-angle branch
    q[4:8] = [-1.0, 0.0, 0.0, 0.0]
    _close(tq.quat_log_map(torch.from_numpy(q)), jq.quat_log_map(q))


def test_so3_host_helpers():
    for rpy in [(0.1, -0.2, 0.3), (np.pi / 2, 0.0, -np.pi / 4), (0.0, 0.0, 0.0)]:
        np.testing.assert_array_equal(tso3.rpy_to_matrix_np(*rpy), jso3.rpy_to_matrix_np(*rpy))
    v = np.array([0.3, -1.2, 2.0])
    np.testing.assert_array_equal(tso3.skew_np(v), jso3.skew_np(v))
