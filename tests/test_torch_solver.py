"""Parity of the port's solver and registry with the JAX package, and the
exact-IK machinery on a tiny flow.

Randomness differs between the frameworks (threefry vs Philox), so parity
tests pass explicit latents; contract tests compare validity, not bits."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ikflow_tpu import registry as jax_registry
from ikflow_tpu.flow import tiny_model_params as jax_tiny
from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu.solver import IKFlowSolver as JaxSolver
from ikflow_tpu.solver import derive_retry_capacities as jax_derive_retry_capacities
from ikflow_tpu_torch import config, registry
from ikflow_tpu_torch.checkpoints import params_from_jax
from ikflow_tpu_torch.flow import tiny_model_params
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.solver import (
    IKFlowSolver,
    derive_retry_capacities,
    draw_latent,
    merge_tier,
    retry_indices,
)


def _solver_pair(sigmoid=False, seed=0):
    hp = jax_tiny()
    hp.dim_latent_space = 7 if sigmoid else 8
    hp.sigmoid_on_output = sigmoid
    hp.softflow_enabled = not sigmoid
    js = JaxSolver(hp, jax_get_robot("panda"), seed=seed)
    thp = tiny_model_params()
    for k, v in hp.to_dict().items():
        setattr(thp, k, v)
    ts = IKFlowSolver(thp, get_robot("panda"), device="cpu",
                      params=params_from_jax(jax.tree_util.tree_map(np.asarray, js.params)))
    return js, ts


def _reachable(n, seed, eps=0.05):
    robot = get_robot("panda")
    q = robot.sample_joint_angles(n, torch.Generator().manual_seed(seed), joint_limit_eps=eps)
    return robot.forward_kinematics(q)


@pytest.mark.parametrize("sigmoid", [False, True])
def test_generate_ik_solutions_explicit_latent_matches_jax(sigmoid):
    js, ts = _solver_pair(sigmoid)
    poses = _reachable(24, seed=1).numpy()
    latent = np.random.default_rng(2).normal(size=(24, ts.network_width)).astype(np.float32)
    for clamp in (True, False):
        out_t = ts.generate_ik_solutions(poses, latent=torch.from_numpy(latent), clamp_to_joint_limits=clamp,
                                         return_detailed=True)
        out_j = js.generate_ik_solutions(jnp.asarray(poses), latent=jnp.asarray(latent),
                                         clamp_to_joint_limits=clamp, return_detailed=True, allow_uninitialized=True)
        for t, j in zip(out_t, out_j[:4]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)


def test_single_pose_mode_and_seeded_generator():
    _, ts = _solver_pair()
    pose = _reachable(1, seed=3)[0]
    a = ts.generate_ik_solutions(pose, n=9, generator=torch.Generator().manual_seed(4))
    b = ts.generate_ik_solutions(pose, n=9, generator=torch.Generator().manual_seed(4))
    assert a.shape == (9, 7) and torch.equal(a, b)
    assert not bool(get_robot("panda").joint_limits_exceeded(a).any())
    with pytest.raises(ValueError):
        ts.generate_ik_solutions(pose)


def test_draw_latent():
    g = torch.Generator().manual_seed(0)
    z = draw_latent(g, "gaussian", 0.5, (4000, 7))
    assert z.shape == (4000, 7) and abs(float(z.std()) - 0.5) < 0.02
    u = draw_latent(g, "uniform", 0.75, (4000, 7))
    assert float(u.min()) >= -0.75 and float(u.max()) <= 0.75 and float(u.max()) > 0.7
    with pytest.raises(ValueError):
        draw_latent(g, "laplace", 1.0, (2, 7))


@pytest.mark.parametrize("counts", [(908, 993, 1000), (500, 900, 990), (999, 1000, 1000), (990, 990, 990)])
def test_derive_retry_capacities_matches_jax(counts):
    assert derive_retry_capacities(counts, 1000, 3) == jax_derive_retry_capacities(counts, 1000, 3)


def _compaction_reference(valids, cap, tier_valid, tier_sols, sols):
    """The JAX package's retry compaction (solver.py:434-452) in numpy."""
    idx = np.argsort(valids, kind="stable")[:cap]
    prev = valids[idx]
    take = ~prev & tier_valid
    sols, valids = sols.copy(), valids.copy()
    sols[idx] = np.where(take[:, None], tier_sols, sols[idx])
    valids[idx] = prev | tier_valid
    return idx, sols, valids


@pytest.mark.parametrize("seed,cap", [(0, 8), (1, 16), (2, 40)])
def test_tier_compaction_against_fixed_masks(seed, cap):
    rng = np.random.default_rng(seed)
    n = 40
    valids = rng.uniform(size=n) < 0.7
    sols = rng.normal(size=(n, 7)).astype(np.float32)
    tier_valid = rng.uniform(size=cap) < 0.5
    tier_sols = rng.normal(size=(cap, 7)).astype(np.float32)
    idx_ref, sols_ref, valids_ref = _compaction_reference(valids, cap, tier_valid, tier_sols, sols)
    idx = retry_indices(torch.from_numpy(valids), cap)
    np.testing.assert_array_equal(idx.numpy(), idx_ref)
    s, v = torch.from_numpy(sols.copy()), torch.from_numpy(valids.copy())
    merge_tier(s, v, idx, torch.from_numpy(tier_sols), torch.from_numpy(tier_valid))
    np.testing.assert_array_equal(s.numpy(), sols_ref)
    np.testing.assert_array_equal(v.numpy(), valids_ref)


def test_exact_tiers_compact_skip_and_count(monkeypatch):
    """Drive generate_exact_ik_solutions with a tier solver that returns fixed
    masks: tier 2 must retry the invalid poses first (capped), and tier 3 must
    be skipped once every pose is valid."""
    _, ts = _solver_pair()
    n = 20
    poses = _reachable(n, seed=5)
    first_valid = np.arange(n) % 3 != 0  # 7 poses miss tier 1
    calls = []

    def fake_solve_tier(sub_poses, g, r, *args):
        k = len(calls)
        calls.append((sub_poses.clone(), r))
        m = sub_poses.shape[0]
        valid = torch.from_numpy(first_valid) if k == 0 else torch.ones(m, dtype=torch.bool)
        return torch.full((m, 7), float(k + 1)), valid

    monkeypatch.setattr(ts, "_solve_tier", fake_solve_tier)
    sols, valids, counts = ts.generate_exact_ik_solutions(
        poses, repeat_counts=(1, 3, 10), retry_capacities=(1.0, 0.4, 0.4), return_tier_counts=True)
    assert [r for _, r in calls] == [1, 3]
    cap = max(8, math.ceil(0.4 * n))
    idx_ref = np.argsort(first_valid, kind="stable")[:cap]
    torch.testing.assert_close(calls[1][0], poses[idx_ref])
    assert counts.tolist() == [13, 20, 20] and bool(valids.all())
    expect = np.where(first_valid, 1.0, 2.0)
    np.testing.assert_array_equal(sols[:, 0].numpy(), expect)


def test_exact_ik_tiny_flow_converges():
    _, ts = _solver_pair()
    robot = ts.robot
    poses = _reachable(48, seed=6)
    sols, valids = ts.generate_exact_ik_solutions(
        poses, repeat_counts=(1, 3, 10), pos_error_threshold=1e-3, rot_error_threshold=0.01,
        n_opt_steps_max=20, generator=torch.Generator().manual_seed(7))
    assert sols.shape == (48, 7)
    assert float(valids.float().mean()) > 0.9
    ev = ts.evaluate(poses, sols)
    assert float(ev.pos_errors[valids].max()) < 1e-3 and float(ev.rot_errors[valids].max()) < 0.01
    assert not bool(robot.joint_limits_exceeded(sols[valids], eps=1e-6).any())


def test_uninitialized_guard_and_device_rule(monkeypatch):
    hp = tiny_model_params()
    hp.dim_latent_space = 8
    s = IKFlowSolver(hp, get_robot("panda"), device="cpu")
    with pytest.raises(RuntimeError):
        s.generate_ik_solutions(_reachable(2, seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IKFlowSolver(hp, get_robot("panda"))
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_model_descriptions_equal_to_jax():
    with open(registry.DESCRIPTIONS_PATH) as f:
        own = yaml.safe_load(f)
    assert registry.model_descriptions() == own == jax_registry.model_descriptions()
    with pytest.raises(ValueError):
        registry.get_ik_solver("nope", device="cpu")


def test_registry_without_weights(monkeypatch, tmp_path):
    monkeypatch.setattr(config, "MODEL_SEARCH_DIRS", (str(tmp_path),))
    with pytest.raises(FileNotFoundError):
        registry.get_ik_solver("panda_lite_tpm", device="cpu")


def _sigmoid_weights():
    path = registry.resolve_weights_path(registry.model_descriptions()["panda__full__sigmoid"])
    if not os.path.exists(path):
        pytest.skip("panda__full_sigmoid.npz is not in the model search path")
    return path


def test_full_sigmoid_model_inverse_matches_jax():
    """panda__full__sigmoid (12 blocks, width 1024) loaded by both registries.

    atol 3e-4: fp32 sums over K = 1024 taken in another order compound through
    24 subnets, 12 exp-affine couplings and the sigmoid head; the largest
    difference measured on these inputs is 1.44e-4 (2 of 448 values above 1e-4)."""
    _sigmoid_weights()
    ts, thp = registry.get_ik_solver("panda__full__sigmoid", device="cpu")
    js, _ = jax_registry.get_ik_solver("panda__full__sigmoid")
    assert thp.nb_nodes == 12 and thp.coeff_fn_internal_size == 1024 and ts.flow.dim_cond == 7
    rng = np.random.default_rng(0)
    z = rng.normal(size=(64, 7)).astype(np.float32)
    cond = _reachable(64, seed=8).numpy()
    qt, _ = ts.flow.inverse(ts.params, torch.from_numpy(z), torch.from_numpy(cond))
    qj, _ = js.flow.inverse(js.params, jnp.asarray(z), jnp.asarray(cond))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=3e-4, rtol=0)


@pytest.mark.slow
def test_exact_ik_contract_trained_sigmoid_cpu():
    """The trained contract on the CPU: 1000 reachable poses, tiers (1, 3, 10),
    3 LM steps, 1 mm / 0.01 rad, at least 99% solved, all inside limits."""
    _sigmoid_weights()
    ts, _ = registry.get_ik_solver("panda__full__sigmoid", device="cpu")
    robot = ts.robot
    g = torch.Generator().manual_seed(42)
    targets = robot.forward_kinematics(robot.sample_joint_angles(1000, g, joint_limit_eps=0.02))
    sols, valids = ts.generate_exact_ik_solutions(
        targets, repeat_counts=(1, 3, 10), pos_error_threshold=1e-3, rot_error_threshold=0.01,
        n_opt_steps_max=3, generator=g)
    assert float(valids.float().mean()) >= 0.99
    assert not bool(robot.joint_limits_exceeded(sols[valids], eps=1e-6).any())
    ev = ts.evaluate(targets, sols)
    assert float(ev.pos_errors[valids].max()) <= 1e-3 + 1e-6
    assert float(ev.rot_errors[valids].max()) <= 0.01 + 1e-6
