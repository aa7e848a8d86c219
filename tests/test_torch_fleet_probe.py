"""The port's streaming policies other than "compact" (``"probe"`` with its
capacity cache and degraded-chunk re-solve, explicit capacity tuples,
``None``) against the JAX package's ``solve_exact_megabatch``.

Randomness differs between the frameworks, so the accounting is compared
with both chunk solves replaced by one deterministic oracle (the same chunks
with the same capacities, in the same order, the same merged results and the
same cache entries, exactly); the real solve on a tiny flow is held to its
contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.parallel import fleet as jax_fleet
from ikflow_tpu_torch.parallel import fleet
from test_torch_fleet import _tiny_solver
from test_torch_solver import _reachable, _solver_pair

PROBE_FRACTIONS = (0.8, 0.95, 1.0)  # the oracle's cumulative valid share after each tier of an uncapped chunk


def _outcome(i, capped, degrade):
    """Pose i's outcome: solutions that do not depend on the call, valid
    unless the chunk is capped and ``degrade`` fails every fifth pose."""
    i = np.asarray(i, np.int64)
    sols = np.zeros((i.shape[0], 7), np.float32)
    sols[:, 0], sols[:, 1] = i, 7
    valid = ~(capped & degrade & (i % 5 == 0))
    return sols, valid


def _tier_counts(m):
    return np.array([int(f * m) for f in PROBE_FRACTIONS], np.int32)


@pytest.mark.parametrize("degrade", [False, True])
def test_probe_accounting_matches_jax(monkeypatch, degrade):
    """300 poses, chunks of 64 and 128: the probe chunk, the capped steady
    chunks and (with ``degrade``) the uncapped re-solves go out alike, the
    capacities come from the same tier counts, the results merge alike, and
    a degraded chunk drops the cache entry in both packages."""
    n = 300
    poses = np.zeros((n, 7), np.float32)
    poses[:, 0] = np.arange(n)
    jax_log, port_log = [], []

    def jax_sharded(solver, chunk, mesh=None, key=None, retry_capacities=None, return_tier_counts=False, **kw):
        i = np.asarray(chunk)[:, 0].astype(int)
        jax_log.append((tuple(i), retry_capacities))
        s, v = _outcome(i, retry_capacities is not None, degrade)
        out = (jnp.asarray(s), jnp.asarray(v))
        return out + (jnp.asarray(_tier_counts(i.shape[0])),) if return_tier_counts else out

    def port_chunk(solver, chunk, g, repeat_counts, capacities, tol):
        i = chunk[:, 0].numpy().astype(int)
        port_log.append((tuple(i), capacities))
        s, v = _outcome(i, capacities is not None, degrade)
        return fleet._pack(torch.from_numpy(s), torch.from_numpy(v)), torch.from_numpy(_tier_counts(i.shape[0]))

    monkeypatch.setattr(jax_fleet, "solve_exact_sharded", jax_sharded)
    monkeypatch.setattr(fleet, "_exact_chunk", port_chunk)
    js, ts = _solver_pair()
    kw = dict(chunk_size=64, steady_chunk=128, retry_capacities="probe", repeat_counts=(1, 2, 4),
              allow_uninitialized=True)
    js_sols, js_valids = jax_fleet.solve_exact_megabatch(js, poses, key=jax.random.PRNGKey(1), **kw)
    ts_sols, ts_valids, stats = fleet.solve_exact_megabatch(ts, poses, seed=1, return_stats=True, **kw)
    caps = jax_log[1][1]
    assert caps is not None and caps[0] == 1.0 and caps[1] < 1.0
    assert [(rows, c and tuple(c)) for rows, c in port_log] == [(rows, c and tuple(c)) for rows, c in jax_log]
    np.testing.assert_array_equal(ts_valids, js_valids)
    np.testing.assert_array_equal(ts_sols, js_sols)
    assert [s["kind"] for s in stats][:1] == ["probe"] and stats[0]["capacities"] is None
    assert (sum(s["kind"] == "resolve" for s in stats) > 0) == degrade
    jax_cache = jax_fleet._CAPACITY_CACHE.get(js, {})
    assert len(ts.capacity_cache) == len(jax_cache) == (0 if degrade else 1)
    if not degrade:
        assert list(ts.capacity_cache.values()) == [tuple(v) for v in jax_cache.values()]
    assert bool(ts_valids.all())  # re-solved uncapped where the capped chunk fell short


def test_probe_keeps_the_valid_share_of_uncapped_chunks():
    """The real solve on a tiny flow: the probe's capped chunks and their
    re-solves reach the valid share of uncapped chunks (within 0.01), and
    every valid solution meets the tolerance."""
    solver = _tiny_solver()
    poses = _reachable(256, seed=0)
    kw = dict(chunk_size=64, steady_chunk=128, seed=1, repeat_counts=(1, 2, 4), n_opt_steps_max=15,
              pos_error_threshold=0.25, rot_error_threshold=1.0, allow_uninitialized=True, capacity_cache=False)
    sols, valids, stats = fleet.solve_exact_megabatch(solver, poses, retry_capacities="probe", return_stats=True, **kw)
    _, valids_full = fleet.solve_exact_megabatch(solver, poses, retry_capacities=None, **kw)
    caps = stats[1]["capacities"]
    assert stats[0]["kind"] == "probe" and caps is not None and caps[1] < 1.0  # tiers really capped
    assert caps == list(fleet.derive_retry_capacities(stats[0]["tier_counts"], 64, 3))
    assert valids.mean() >= valids_full.mean() - 0.01
    assert not solver.capacity_cache  # capacity_cache=False leaves the cache alone
    pos_err = torch.linalg.norm(solver.robot.forward_kinematics(torch.from_numpy(sols[valids]))[:, :3]
                                - poses[valids][:, :3], dim=1)
    assert float(pos_err.max()) <= 0.25 + 1e-6


def _cache_run(solver, poses, seed):
    out = fleet.solve_exact_megabatch(solver, poses, chunk_size=16, seed=seed, retry_capacities="probe",
                                      repeat_counts=(2,), n_opt_steps_max=1, pos_error_threshold=10.0,
                                      rot_error_threshold=10.0, allow_uninitialized=True, return_stats=True)
    return [s["kind"] for s in out[2]]


def test_capacity_cache_hits_and_misses_after_new_weights():
    """The second call reuses the cached capacities (no probe chunk); new
    weights, through ``set_params`` or by assigning ``params``, miss."""
    solver = _tiny_solver()
    poses = _reachable(40, seed=5)
    assert _cache_run(solver, poses, 1)[0] == "probe" and len(solver.capacity_cache) == 1
    assert "probe" not in _cache_run(solver, poses, 2)
    version = solver.weights_version
    solver.set_params(solver.params)
    assert solver.weights_version == version + 1
    assert _cache_run(solver, poses, 3)[0] == "probe" and len(solver.capacity_cache) == 2
    solver.params = tuple({k: [dict(layer) for layer in blk[k]] for k in blk} for blk in solver.params)
    assert _cache_run(solver, poses, 4)[0] == "probe" and len(solver.capacity_cache) == 3
    assert "probe" not in _cache_run(solver, poses, 5)


@pytest.mark.parametrize("policy", [(1.0, 0.5), None])
def test_explicit_tuple_and_none_policies(policy):
    """A tuple caps every chunk as given, with no probe and no monitoring;
    None runs every chunk uncapped in ``chunk_size`` pieces. Both never
    touch the cache."""
    solver = _tiny_solver()
    poses = _reachable(40, seed=7)
    sols, valids, stats = fleet.solve_exact_megabatch(
        solver, poses, chunk_size=16, steady_chunk=32, seed=1, retry_capacities=policy, repeat_counts=(2, 2),
        n_opt_steps_max=15, allow_uninitialized=True, return_stats=True)
    assert sols.shape == (40, 7) and valids.shape == (40,) and valids.any()
    assert all(s["kind"] == "steady" for s in stats) and not solver.capacity_cache
    assert all(s["capacities"] == (None if policy is None else list(policy)) for s in stats)
    sizes = (32, 16) if policy is not None else (16,)
    assert [s["rows"] for s in stats] == [size for _, size in fleet._plan(40, sizes)]


def test_megabatch_refuses_an_unknown_policy():
    with pytest.raises(ValueError):
        fleet.solve_exact_megabatch(_tiny_solver(), np.zeros((4, 7), np.float32), retry_capacities="greedy",
                                    allow_uninitialized=True)
