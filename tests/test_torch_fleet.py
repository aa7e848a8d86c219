"""The port's streaming megabatch solve, diverse sampling and solution
diversity against the JAX package.

Randomness differs between the frameworks, so the megabatch's accounting is
compared with both chunk solves replaced by one deterministic oracle (the
same dispatches, in the same order, and the same merged results, exactly),
and the real solve is checked by its contract. Diverse selection is compared
on injected candidates, exactly."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.evaluation import solution_diversity as jax_solution_diversity
from ikflow_tpu.parallel import fleet as jax_fleet
from ikflow_tpu.parallel.mesh import make_mesh
from ikflow_tpu_torch.evaluation import solution_diversity, solution_pose_errors
from ikflow_tpu_torch.flow import tiny_model_params
from ikflow_tpu_torch.parallel import fleet
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.solver import IKFlowSolver, select_diverse
from test_torch_solver import _reachable, _solver_pair


@pytest.mark.parametrize("sizes", [(32768, 8192, 2048), (8192, 2048), (16,), (64, 16, 16)])
def test_plan_matches_jax(sizes):
    for total in itertools.chain(range(0, 200), (2047, 2048, 2049, 10000, 32767, 32768, 100000, 131073)):
        assert fleet._plan(total, sizes) == jax_fleet._plan(total, sizes), total


def _tiny_solver(seed=0):
    hp = tiny_model_params()
    hp.dim_latent_space = 8
    return IKFlowSolver(hp, get_robot("panda"), seed=seed, device="cpu")


@pytest.mark.parametrize("n", [70, 10])
def test_megabatch_compact_retries_only_misses(n):
    """The JAX package's compact scenario (chunks of 16, tiers (1, 2, 4), 20
    LM steps) on a ragged 70 poses and on 10 poses, fewer than one chunk:
    each retry tier solves exactly the poses still invalid, valid counts never
    fall, and every valid solution meets the tolerance."""
    solver = _tiny_solver()
    poses = _reachable(n, seed=2)
    sols, valids, stats = fleet.solve_exact_megabatch(
        solver, poses, chunk_size=16, seed=1, repeat_counts=(1, 2, 4), n_opt_steps_max=20,
        allow_uninitialized=True, return_stats=True,
    )
    assert sols.shape == (n, 7) and sols.dtype == np.float32 and valids.shape == (n,) and valids.dtype == bool
    assert valids.any()
    assert stats[0]["rows"] == n and stats[0]["chunks"] == len(fleet._plan(n, (32768, 8192, 16)))
    assert stats[0]["chunk_rows"] == [size for _, size in fleet._plan(n, (32768, 8192, 16))]
    for prev, cur in zip(stats, stats[1:]):
        assert cur["rows"] == n - prev["valid"] and cur["valid"] >= prev["valid"]
        assert cur["chunks"] == len(fleet._plan(cur["rows"], (8192, 16)))
        assert cur["chunk_rows"] == [size for _, size in fleet._plan(cur["rows"], (8192, 16))]
    assert stats[-1]["valid"] == int(valids.sum())
    pos_err, rot_err = solution_pose_errors(solver.robot, torch.from_numpy(sols[valids]), poses[valids])
    assert float(pos_err.max()) < 1e-3 + 1e-6 and float(rot_err.max()) < 0.1 + 1e-6
    again = fleet.solve_exact_megabatch(solver, poses, chunk_size=16, seed=1, repeat_counts=(1, 2, 4),
                                        n_opt_steps_max=20, allow_uninitialized=True)
    np.testing.assert_array_equal(again[0], sols)  # chunk generators derive from (seed, tier, chunk start)


def _oracle(i, r, start):
    """Pose i's outcome in a chunk of repeat count r starting at ``start``:
    valid for some chunks and not others, so overlapping windows disagree."""
    i = np.asarray(i, np.int64)
    valid = (i * 7 + r * 13 + start) % 5 < 2
    sols = np.zeros((i.shape[0], 7), np.float32)
    sols[:, 0], sols[:, 1], sols[:, 2] = i, r, start
    return sols, valid


def test_megabatch_accounting_matches_jax(monkeypatch):
    """Same scenario with both chunk solves replaced by ``_oracle``: the same
    chunks go out per tier (rows, padding, start), and first-valid-wins gives
    the same solutions and valids, exactly; no valid pose is downgraded."""
    n, repeat_counts = 70, (1, 2, 4)
    poses = np.zeros((n, 7), np.float32)
    poses[:, 0] = np.arange(n)
    jax_log, port_log = [], []

    def jax_chunk_fn(solver, size, r, gather, sk):
        def fn(params, aux, poses_dev, fetch, tag, key):
            p = np.asarray(poses_dev)
            chunk = p[np.asarray(fetch)] if gather else p[int(fetch) : int(fetch) + size]
            jax_log.append((r, int(tag), tuple(chunk[:, 0].astype(int))))
            s, v = _oracle(chunk[:, 0], r, int(tag))
            return jnp.asarray(np.concatenate([s, v[:, None].astype(np.float32)], axis=1))

        return fn

    def port_chunk(solver, chunk, r, seed, salt, start, sk):
        i = chunk[:, 0].numpy().astype(int)
        port_log.append((r, start, tuple(i)))
        s, v = _oracle(i, r, start)
        return fleet._pack(torch.from_numpy(s), torch.from_numpy(v))

    monkeypatch.setattr(jax_fleet, "_fused_chunk_fn", jax_chunk_fn)
    monkeypatch.setattr(fleet, "_solve_chunk", port_chunk)
    hp_solver, ts = _solver_pair()
    js_out = jax_fleet.solve_exact_megabatch(
        hp_solver, poses, chunk_size=16, mesh=make_mesh(jax.devices()[:1]), key=jax.random.PRNGKey(1),
        retry_capacities="compact", repeat_counts=repeat_counts, allow_uninitialized=True,
    )
    ts_sols, ts_valids, stats = fleet.solve_exact_megabatch(
        ts, poses, chunk_size=16, seed=1, repeat_counts=repeat_counts, allow_uninitialized=True, return_stats=True,
    )
    assert port_log == jax_log and len({entry[0] for entry in port_log}) == 3
    np.testing.assert_array_equal(ts_valids, js_out[1])
    np.testing.assert_array_equal(ts_sols, js_out[0])
    # Never downgraded: a pose's solution is the first valid one it was given.
    for i in range(n):
        first = next(((r, start) for r, start, rows in port_log if i in rows and _oracle([i], r, start)[1][0]), None)
        assert ts_valids[i] == (first is not None)
        if first is not None:
            assert tuple(ts_sols[i, 1:3]) == first
    assert [s["chunks"] for s in stats] == [sum(1 for e in port_log if e[0] == r) for r in repeat_counts]


@pytest.mark.parametrize("kwargs", [
    {"retry_capacities": "probe"}, {"retry_capacities": (1.0, 0.5, 0.1)}, {"retry_capacities": None},
    {"mesh": "two-gpu mesh"},
])
def test_megabatch_unported_policies_raise(kwargs):
    """Only a mesh (several GPUs) is left unported; the other policies run
    on one device (``tests/test_torch_fleet_probe.py`` holds them to JAX)."""
    if "mesh" in kwargs:
        with pytest.raises(NotImplementedError):
            fleet.solve_exact_megabatch(_tiny_solver(), np.zeros((4, 7), np.float32), allow_uninitialized=True,
                                        **kwargs)
        return
    sols, valids = fleet.solve_exact_megabatch(_tiny_solver(), _reachable(4, seed=1), chunk_size=4,
                                               repeat_counts=(1, 2, 4), n_opt_steps_max=1, allow_uninitialized=True,
                                               **kwargs)
    assert sols.shape == (4, 7) and valids.shape == (4,)


def test_megabatch_refuses_unknown_kwargs_and_unloaded_weights():
    with pytest.raises(TypeError):
        fleet.solve_exact_megabatch(_tiny_solver(), np.zeros((4, 7), np.float32), allow_uninitialized=True,
                                    bogus=1)
    with pytest.raises(RuntimeError):
        fleet.solve_exact_megabatch(_tiny_solver(), np.zeros((4, 7), np.float32))


def _candidates(kind, m):
    rng = np.random.default_rng(m)
    if kind == "grid":  # integer coordinates: exact, tied distances, so first-index tie breaks show
        return rng.integers(-2, 3, size=(m, 7)).astype(np.float32)
    return rng.uniform(-2.5, 2.5, size=(m, 7)).astype(np.float32)


@pytest.mark.parametrize("kind,n,oversample", [("uniform", 16, 8), ("uniform", 5, 3), ("grid", 12, 4), ("grid", 1, 4)])
def test_diverse_selection_matches_jax(monkeypatch, kind, n, oversample):
    js, ts = _solver_pair()
    cands = _candidates(kind, n * oversample)
    monkeypatch.setattr(js, "generate_ik_solutions", lambda *a, **k: jnp.asarray(cands))
    monkeypatch.setattr(ts, "generate_ik_solutions", lambda *a, **k: torch.from_numpy(cands))
    pose = np.zeros(7, np.float32)
    out_j = np.asarray(js.generate_diverse_ik_solutions(pose, n, oversample=oversample, allow_uninitialized=True))
    out_t = ts.generate_diverse_ik_solutions(pose, n, oversample=oversample, allow_uninitialized=True).numpy()
    np.testing.assert_array_equal(out_t, out_j)
    chosen = select_diverse(torch.from_numpy(cands), n).numpy()
    assert chosen[0] == 0 and len(set(chosen.tolist())) == n
    np.testing.assert_array_equal(cands[chosen], out_t)


def test_generate_diverse_spreads_the_candidates():
    solver = _tiny_solver()
    pose = _reachable(1, seed=9)[0]
    out = solver.generate_diverse_ik_solutions(pose, 8, oversample=4, generator=torch.Generator().manual_seed(3),
                                               allow_uninitialized=True)
    raw = solver.generate_ik_solutions(pose, n=32, generator=torch.Generator().manual_seed(3),
                                       allow_uninitialized=True)
    assert out.shape == (8, 7) and not bool(solver.robot.joint_limits_exceeded(out).any())
    assert torch.unique(out, dim=0).shape[0] == 8
    assert all(bool((raw == row).all(dim=1).any()) for row in out)  # picked among the candidates

    def min_pairwise(x):
        d = torch.cdist(x.double(), x.double())
        return float(d[~torch.eye(x.shape[0], dtype=torch.bool)].min())

    assert min_pairwise(out) > min_pairwise(raw[:8])
    with pytest.raises(ValueError):
        solver.generate_diverse_ik_solutions(pose, 0, allow_uninitialized=True)


def test_solution_diversity_matches_jax():
    sols = np.random.default_rng(4).normal(size=(3 * 5, 7)).astype(np.float32)
    np.testing.assert_allclose(solution_diversity(torch.from_numpy(sols), 3, 5).numpy(),
                               np.asarray(jax_solution_diversity(jnp.asarray(sols), 3, 5)), rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        solution_diversity(torch.from_numpy(sols), 15, 1)
