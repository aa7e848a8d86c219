"""Exact IK over a mesh on the CPU (``[cpu] * k``): the port's
``solve_exact_sharded``, the mesh megabatch and ``scaling_efficiency``
against its unsharded solve and against the JAX package on its virtual
8-device CPU mesh.

Tolerances:
- sharded vs unsharded with the same generator: every shard gets exactly its
  rows of the tier's latents and restart draws (checked bit for bit), and at
  JAX's test point (``tests/test_sharding.py:60-76``: 32 poses, tiers (1, 2),
  3 LM steps) the solutions agree within 1e-6 with equal valids. Where LM
  refines poses to validity, the CPU's vector kernels round the tail of a
  batch another way than its body, so a pose's rounding depends on the batch
  it is in, and LM's JᵀJ + λI (condition number near 1e8 at λ = 1e-4)
  amplifies that up to 9e-4 rad and can flip a pose's validity; at λ = 0.1
  (ROADMAP §3's parity note) valids and tier counts are equal and the
  solutions within 1e-4 (measured at most 8.8e-6);
- against JAX with injected latents and no restarts: the flow seeds within
  1e-4 (the explicit-latent parity bar of ``tests/test_torch_solver.py``),
  refined solutions within 1e-4 at λ = 0.1 (ROADMAP §3's parity note) with
  equal valids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.parallel import fleet as jax_fleet
from ikflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ikflow_tpu_torch import solver as solver_module
from ikflow_tpu_torch.evaluation import solution_pose_errors
from ikflow_tpu_torch.parallel import fleet
from ikflow_tpu_torch.parallel.mesh import make_mesh
from ikflow_tpu_torch.solver import IKFlowSolver
from test_torch_fleet import _tiny_solver
from test_torch_solver import _reachable, _solver_pair

CPU = torch.device("cpu")


def _mesh(k):
    return make_mesh([CPU] * k)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def test_sharded_exact_ik_matches_unsharded():
    """JAX's test point: 32 poses, tiers (1, 2), 3 LM steps."""
    ts = _tiny_solver()
    poses = _reachable(32, seed=1)
    kw = dict(repeat_counts=(1, 2), n_opt_steps_max=3, allow_uninitialized=True)
    s1, v1 = ts.generate_exact_ik_solutions(poses, generator=_gen(), **kw)
    s2, v2 = fleet.solve_exact_sharded(ts, poses, _mesh(4), generator=_gen(), **kw)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_each_shard_gets_its_rows_of_the_unsharded_draws(monkeypatch, k):
    """Every shard's latents and restart draws are its rows (``t * n + i``)
    of the draws the unsharded tier makes, bit for bit, and the refined
    result agrees (valids and tier counts equal)."""
    ts = _tiny_solver()
    poses = _reachable(32, seed=2)
    kw = dict(repeat_counts=(2, 3), n_opt_steps_max=8, pos_error_threshold=1e-2, rot_error_threshold=0.1,
              lambd=0.1, allow_uninitialized=True)
    seen = []
    tier = IKFlowSolver._solve_tier

    def recorded(self, p, g, r, *tol, latent=None, restart_noise=None):
        seen.append((p.shape[0], r, latent, restart_noise))
        return tier(self, p, g, r, *tol, latent=latent, restart_noise=restart_noise)

    monkeypatch.setattr(IKFlowSolver, "_solve_tier", recorded)
    s2, v2, c2 = fleet.solve_exact_sharded(ts, poses, _mesh(k), generator=_gen(), return_tier_counts=True, **kw)
    monkeypatch.setattr(IKFlowSolver, "_solve_tier", tier)
    s1, v1, c1 = ts.generate_exact_ik_solutions(poses, generator=_gen(), return_tier_counts=True, **kw)
    assert c1.tolist() == c2.tolist() and 0 < int(c1[-1]) < 32
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-4, rtol=0)

    # Replay the unsharded draws of each tier and match every shard's rows.
    g = _gen()
    tiers_run = [r for r, c_prev in zip(kw["repeat_counts"], [0] + c1.tolist()[:-1]) if c_prev < 32]
    for r in tiers_run:
        shards, seen = seen[:k], seen[k:]
        n = sum(m for m, *_ in shards)
        latent = torch.randn((r * n, ts.network_width), generator=g)
        noise = torch.stack([torch.rand((r * n, 7), generator=g) for _ in range(kw["n_opt_steps_max"])])
        start = 0
        for m, r_seen, lat, nz in shards:
            rows = (torch.arange(r)[:, None] * n + torch.arange(start, start + m)[None, :]).reshape(-1)
            assert r_seen == r
            torch.testing.assert_close(lat, latent[rows], rtol=0, atol=0)
            torch.testing.assert_close(nz, noise[:, rows], rtol=0, atol=0)
            start += m
    assert seen == []


def test_padding_and_trimming():
    """30 poses over 4 entries: padded to 32 with copies of pose 0 (the
    tier counts count the padded set), trimmed back to 30, and equal to the
    unsharded solve of the padded set."""
    ts = _tiny_solver()
    poses = _reachable(30, seed=4)
    kw = dict(repeat_counts=(1, 2), n_opt_steps_max=3, allow_uninitialized=True, return_tier_counts=True)
    s, v, counts = fleet.solve_exact_sharded(ts, poses, _mesh(4), generator=_gen(), **kw)
    assert s.shape == (30, 7) and v.shape == (30,)
    padded = torch.cat([poses, poses[:1].expand(2, 7)])
    s1, v1, c1 = ts.generate_exact_ik_solutions(padded, generator=_gen(), **kw)
    assert counts.tolist() == c1.tolist()
    np.testing.assert_allclose(s.numpy(), s1[:30].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(v.numpy(), v1[:30].numpy())


def _injected(monkeypatch, latent):
    """Both packages draw ``latent`` as the tier's seeds (unscaled) and run
    LM without restarts (JAX's ``restart_key=None``)."""
    randn = torch.randn

    def fake_randn(shape, *a, **k):
        return latent.clone() if tuple(shape) == tuple(latent.shape) else randn(shape, *a, **k)

    monkeypatch.setattr(torch, "randn", fake_randn)
    refine = solver_module.refine
    monkeypatch.setattr(solver_module, "refine",
                        lambda *a, restart_generator=None, restart_noise=None, **k: refine(*a, **k))


@pytest.mark.parametrize("steps", [0, 12], ids=["flow_seeds", "refined"])
def test_sharded_solve_matches_jax_sharded(monkeypatch, steps):
    """The port's solve on [cpu] * 4 against JAX's ``solve_exact_sharded``
    on its 8-device virtual mesh, one tier, the same latents, no restarts:
    with 0 LM steps the result is the clamped flow seeds, with 12 the refined
    solutions."""
    js, ts = _solver_pair()
    n = 32
    poses = _reachable(n, seed=5).numpy()
    latent = np.random.default_rng(6).normal(size=(n, ts.network_width)).astype(np.float32)
    kw = dict(repeat_counts=(1,), n_opt_steps_max=steps, lambd=0.1, pos_error_threshold=1e-2,
              rot_error_threshold=0.1, latent_scale=0.75, allow_uninitialized=True)

    def jax_tier(params, aux, p, sub, rk, r, pos_tol, rot_tol, n_steps, lambd, latent_scale):
        from ikflow_tpu.lm import refine as jax_refine

        q0 = js._robot.clamp_to_joint_limits(
            js._inverse_q(params, aux, latent_scale * jnp.asarray(latent), js._conditional(p))[:, :7])
        cap_q, cap_valid, _ = jax_refine(js._robot, q0, p, n_steps, pos_tol, rot_tol, lambd, restart_key=None)
        return cap_q, cap_valid

    monkeypatch.setattr(js, "_solve_tier", jax_tier)
    js_s, js_v = jax_fleet.solve_exact_sharded(js, jnp.asarray(poses), mesh=jax_make_mesh(), **kw)
    _injected(monkeypatch, torch.from_numpy(latent))
    ts_s, ts_v = fleet.solve_exact_sharded(ts, poses, _mesh(4), generator=_gen(), **kw)
    np.testing.assert_allclose(ts_s.numpy(), np.asarray(js_s), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ts_v.numpy(), np.asarray(js_v))
    if steps:
        assert 0 < int(ts_v.sum()) < n


@pytest.mark.parametrize("policy", ["compact", "probe", (1.0, 0.5, 0.25), None], ids=str)
def test_mesh_megabatch_each_policy(monkeypatch, policy):
    """Every policy on a two-entry mesh: each chunk goes through
    ``solve_exact_sharded`` over that mesh, the results have the one-device
    run's shape and valid share (within 0.1), and every valid solution meets
    the tolerance."""
    ts = _tiny_solver()
    poses = _reachable(40, seed=7).numpy()
    kw = dict(chunk_size=16, steady_chunk=32, repeat_counts=(1, 2, 4), n_opt_steps_max=8,
              pos_error_threshold=1e-2, rot_error_threshold=0.1, allow_uninitialized=True,
              retry_capacities=policy, capacity_cache=False)
    meshes = []
    sharded = fleet.solve_exact_sharded

    def recorded(solver, chunk, mesh=None, **k):
        meshes.append(mesh.size)
        return sharded(solver, chunk, mesh, **k)

    monkeypatch.setattr(fleet, "solve_exact_sharded", recorded)
    sols, valids = fleet.solve_exact_megabatch(ts, poses, mesh=_mesh(2), **kw)
    assert meshes and set(meshes) == {2}
    meshes.clear()
    _, valids_one = fleet.solve_exact_megabatch(ts, poses, mesh=_mesh(1), **kw)
    assert meshes == []  # a one-entry mesh runs the one-device path
    assert sols.shape == (40, 7) and np.isfinite(sols).all()
    assert abs(valids.mean() - valids_one.mean()) <= 0.1 and valids.mean() > 0.1
    pos, rot = solution_pose_errors(ts.robot, torch.from_numpy(sols[valids]), torch.from_numpy(poses[valids]))
    assert float(pos.max()) < 1e-2 and float(rot.max()) < 0.1


def test_probe_capacities_carry_across_meshes():
    """As in the JAX package, the capacity cache is keyed by weights and
    solve protocol, not by mesh: a probe on one mesh serves a call on
    another (no probe chunk), and new weights miss it."""
    ts = _tiny_solver()
    poses = _reachable(40, seed=8).numpy()
    kw = dict(chunk_size=16, steady_chunk=32, repeat_counts=(1, 2), n_opt_steps_max=8, pos_error_threshold=1e-2,
              rot_error_threshold=0.1, allow_uninitialized=True, retry_capacities="probe", return_stats=True)
    _, _, stats = fleet.solve_exact_megabatch(ts, poses, mesh=_mesh(2), **kw)
    assert stats[0]["kind"] == "probe" and len(ts.capacity_cache) == 1
    _, _, stats = fleet.solve_exact_megabatch(ts, poses, mesh=_mesh(4), **kw)
    assert all(s["kind"] != "probe" for s in stats) and len(ts.capacity_cache) == 1
    ts.set_params(ts.params)
    _, _, stats = fleet.solve_exact_megabatch(ts, poses, mesh=_mesh(4), **kw)
    assert stats[0]["kind"] == "probe" and len(ts.capacity_cache) == 2


def test_scaling_harness_rows():
    """The JAX package's row keys (``tests/test_fleet.py:133-147``), one row
    per device count, on [cpu] * 2."""
    ts = _tiny_solver()
    rows = fleet.scaling_efficiency(ts, n_poses=32, reps=1, device_counts=(1, None), devices=[CPU] * 2,
                                    repeat_counts=(1,), n_opt_steps_max=1, allow_uninitialized=True)
    assert [sorted(r) for r in rows] == [["devices", "efficiency", "seconds", "sols_per_s"]] * 2
    assert [r["devices"] for r in rows] == [1, 2] and rows[0]["efficiency"] == 1.0
    assert all(r["sols_per_s"] > 0 and np.isfinite(r["seconds"]) for r in rows)
