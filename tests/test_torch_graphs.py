"""The captured serving programs (``ikflow_tpu_torch/graphs.py`` and the
solver's graph path) on the CPU, and on the card where there is one.

A ``torch.cuda.CUDAGraph`` cannot run here, so the cache is driven through a
stub backend whose "graph" reruns the captured program on the static
buffers and writes its outputs in place, as a replay overwrites them. With
it the solver's graph path (draws made ahead and handed in as inputs, a
key's eager first call, its capture, the replays and their clones) runs on
the CPU, and must equal the eager path bit for bit: both run the same
operations on the same numbers. The JAX parity of
the eager path is held by the other ``test_torch_*`` files, unchanged: on the
CPU the port serves eagerly.

Card tests (marked ``gpu``; they skip without CUDA) hold the real graphs to
the eager path on the card:

    python -m pytest tests/test_torch_graphs.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from ikflow_tpu_torch.flow import fused_mlp, fused_mlp_bf16, tiny_model_params
from ikflow_tpu_torch.graphs import DEFAULT_MAX_ENTRIES, WARMUP_CALLS, GraphCache
from ikflow_tpu_torch.parallel import fleet
from ikflow_tpu_torch.parallel.mesh import make_mesh
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.solver import IKFlowSolver

CPU = torch.device("cpu")
TOL = (1e-3, 0.1, 3, 1e-4, 0.75)  # pos tol, rot tol, LM steps, damping, latent scale


class StubGraph:
    def __init__(self, fn, args, outputs):
        self.fn, self.args, self.outputs = fn, args, outputs
        self.was_reset = False

    def replay(self):
        fresh = self.fn(*self.args)
        for out, new in zip(self.outputs, fresh if isinstance(fresh, tuple) else (fresh,)):
            out.copy_(new)


class StubBackend:
    """A backend whose graph reruns the program on the static buffers."""

    def __init__(self, fail_capture=False):
        self.fail_capture = fail_capture
        self.graphs = []

    def capture(self, fn, args):
        out = fn(*args)
        if self.fail_capture:
            raise RuntimeError("operation not permitted when stream is capturing")
        graph = StubGraph(fn, args, out if isinstance(out, tuple) else (out,))
        graph.reset = lambda: setattr(graph, "was_reset", True)
        self.graphs.append(graph)
        return graph, out

    def replay(self, graph):
        graph.replay()


def _tiny_solver():
    hp = tiny_model_params()
    hp.dim_latent_space = 8
    return IKFlowSolver(hp, get_robot("panda"), device="cpu")


def _stub_graphs(monkeypatch, solver, backend=None):
    """Route ``solver``'s work on the CPU through a stub-backed cache."""
    solver._graphs = GraphCache(solver.device, backend=backend or StubBackend())
    monkeypatch.setattr(solver, "_graph_cache", lambda x: solver._graphs)
    return solver._graphs


def _reachable(n, seed):
    robot = get_robot("panda")
    q = robot.sample_joint_angles(n, torch.Generator().manual_seed(seed), joint_limit_eps=0.05)
    return robot.forward_kinematics(q)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# Draws: the graph path's order gives the eager path's numbers.

@pytest.mark.parametrize("r,n_steps", [(1, 3), (3, 3), (2, 0)])
def test_tier_draws_in_graph_order_equal_generator_draws(r, n_steps):
    """``_solve_tier`` with the latents and restart noise drawn ahead in the
    graph path's order (``randn((r n, D))``, then one ``rand((r n, ndof))``
    per LM step) equals ``_solve_tier(g)`` from the same seed, bit for bit."""
    solver = _tiny_solver()
    poses = _reachable(12, seed=1)
    tol = (1e-3, 0.1, n_steps, 1e-4, 0.75)
    eager = solver._solve_tier(poses, _gen(), r, *tol)
    g = _gen()
    latent = torch.randn((r * 12, solver.network_width), generator=g)
    noise = torch.stack([torch.rand((r * 12, solver.ndof), generator=g) for _ in range(n_steps)]) if n_steps else None
    _equal(eager, solver._solve_tier(poses, None, r, *tol, latent=latent, restart_noise=noise))


@pytest.mark.parametrize("r", [1, 3])
def test_tier_graph_path_equals_eager(monkeypatch, r):
    solver = _tiny_solver()
    poses = _reachable(12, seed=1)
    eager = solver._solve_tier(poses, _gen(), r, *TOL)
    graphs = _stub_graphs(monkeypatch, solver)
    _equal(eager, solver._solve_tier(poses, _gen(), r, *TOL))  # the key's first call: eager
    assert graphs.captures == 0 and graphs.replays == 0
    _equal(eager, solver._solve_tier(poses, _gen(), r, *TOL))  # captured and replayed
    _equal(eager, solver._solve_tier(poses, _gen(), r, *TOL))  # replayed
    assert graphs.captures == 1 and graphs.replays == 2


def test_exact_solve_graph_path_equals_eager(monkeypatch):
    solver = _tiny_solver()
    poses = _reachable(20, seed=2)
    kw = dict(repeat_counts=(1, 2, 4), n_opt_steps_max=5, allow_uninitialized=True, return_tier_counts=True)
    eager = solver.generate_exact_ik_solutions(poses, generator=_gen(), **kw)
    graphs = _stub_graphs(monkeypatch, solver)
    for _ in range(3):  # eager, captured, replayed
        _equal(eager, solver.generate_exact_ik_solutions(poses, generator=_gen(), **kw))
    tiers_run = 1 + sum(1 for c in eager[2][:-1] if c < 20)
    assert graphs.captures == tiers_run and graphs.replays == 2 * tiers_run


@pytest.mark.parametrize("detailed", [False, True])
def test_approximate_graph_path_equals_eager(monkeypatch, detailed):
    """The approximate path draws its latents before the graph as the eager
    path does: equal bit for bit, drawn or given."""
    solver = _tiny_solver()
    poses = _reachable(16, seed=4)
    latent = np.random.default_rng(0).normal(size=(16, solver.network_width)).astype(np.float32)
    kw = dict(allow_uninitialized=True, return_detailed=detailed, latent_scale=0.5)
    eager = solver.generate_ik_solutions(poses, generator=_gen(), **kw)
    eager_given = solver.generate_ik_solutions(poses, latent=latent, **kw)
    graphs = _stub_graphs(monkeypatch, solver)
    for _ in range(2):  # the key's eager call and its capture, then two replays
        got = solver.generate_ik_solutions(poses, generator=_gen(), **kw)
        got_given = solver.generate_ik_solutions(poses, latent=latent, **kw)
        if not detailed:
            got, got_given = (got,), (got_given,)
        assert len(got) == (5 if detailed else 1)
        _equal(eager if detailed else (eager,), got)
        _equal(eager_given if detailed else (eager_given,), got_given)
    assert graphs.captures == 1 and graphs.replays == 3


def test_diverse_graph_path_equals_eager(monkeypatch):
    solver = _tiny_solver()
    pose = _reachable(1, seed=5)[0]
    eager = solver.generate_diverse_ik_solutions(pose, 6, oversample=4, generator=_gen(), allow_uninitialized=True)
    graphs = _stub_graphs(monkeypatch, solver)
    for _ in range(WARMUP_CALLS + 1):
        got = solver.generate_diverse_ik_solutions(pose, 6, oversample=4, generator=_gen(), allow_uninitialized=True)
        assert torch.equal(eager, got)
    keys = [k[0] for k in graphs._entries]
    assert keys == ["generate", "diverse"]


def test_sharded_and_megabatch_graph_paths_equal_eager(monkeypatch):
    """The sharded tier hands each shard its rows of the draws, the chunk
    path draws from the chunk's generator: both take the graph unchanged."""
    solver = _tiny_solver()
    poses = _reachable(24, seed=6)
    kw = dict(repeat_counts=(1, 2), n_opt_steps_max=3, allow_uninitialized=True, lambd=0.1)
    mb_kw = dict(chunk_size=16, seed=1, repeat_counts=(1, 2, 4), n_opt_steps_max=5, allow_uninitialized=True)
    eager_sharded = fleet.solve_exact_sharded(solver, poses, make_mesh([CPU, CPU]), generator=_gen(), **kw)
    eager_mb = fleet.solve_exact_megabatch(solver, poses, **mb_kw)
    graphs = _stub_graphs(monkeypatch, solver)
    _equal(eager_sharded, fleet.solve_exact_sharded(solver, poses, make_mesh([CPU, CPU]), generator=_gen(), **kw))
    got_mb = fleet.solve_exact_megabatch(solver, poses, **mb_kw)
    np.testing.assert_array_equal(eager_mb[0], got_mb[0])
    np.testing.assert_array_equal(eager_mb[1], got_mb[1])
    assert graphs.captures > 0


# --------------------------------------------------------------------------
# The cache.

def test_cache_first_call_eager_then_capture_then_replays():
    """A key's first call runs eagerly (no capture), its second captures and
    replays, later calls replay; each returns fresh tensors."""
    backend = StubBackend()
    cache = GraphCache(CPU, backend=backend)
    x = torch.arange(4.0)
    program = lambda t: (t * 2.0, t + 1.0)  # noqa: E731
    a, b = cache.run("k", program, (x,))
    assert torch.equal(a, x * 2) and torch.equal(b, x + 1)
    assert backend.graphs == [] and cache.captures == 0 and cache.replays == 0 and len(cache) == 0
    a1, _ = cache.run("k", program, (x + 5,))
    assert cache.captures == 1 and cache.replays == 1 and len(cache) == 1
    a2, _ = cache.run("k", program, (x + 10,))
    assert cache.captures == 1 and cache.replays == 2
    # the earlier results survive the replay that overwrote the static outputs
    assert torch.equal(a1, (x + 5) * 2) and torch.equal(a2, (x + 10) * 2)
    assert cache.capture_seconds > 0


def test_cache_lru_eviction_resets_graphs():
    backend = StubBackend()
    cache = GraphCache(CPU, backend=backend)
    x = torch.ones(3)
    keys = list(range(DEFAULT_MAX_ENTRIES + 1))
    for key in keys[:-1]:
        for _ in range(WARMUP_CALLS):
            cache.run(key, lambda t: t * 3.0, (x,))
    cache.run(0, lambda t: t * 3.0, (x,))  # key 0 is now the most recent
    for _ in range(WARMUP_CALLS):
        cache.run(keys[-1], lambda t: t * 3.0, (x,))
    assert len(cache) == DEFAULT_MAX_ENTRIES and 1 not in cache._entries
    assert list(cache._entries)[-2:] == [0, keys[-1]]
    assert [g.was_reset for g in backend.graphs] == [False, True] + [False] * (DEFAULT_MAX_ENTRIES - 1)
    # keys called once are remembered within the same bound
    for key in range(100, 100 + DEFAULT_MAX_ENTRIES + 1):
        cache.run(key, lambda t: t * 3.0, (x,))
    assert len(cache._seen) == DEFAULT_MAX_ENTRIES and 100 not in cache._seen
    cache.clear()
    assert len(cache) == 0 and not cache._seen and all(g.was_reset for g in backend.graphs)


def test_solver_keys_and_set_params_empties_the_cache(monkeypatch):
    solver = _tiny_solver()
    poses = _reachable(8, seed=7)
    graphs = _stub_graphs(monkeypatch, solver)
    version = solver.weights_version
    for _ in range(WARMUP_CALLS):
        solver._solve_tier(poses, _gen(), 3, *TOL)
    assert list(graphs._entries) == [("tier", 8, 3) + TOL + (version, CPU)]
    for _ in range(WARMUP_CALLS):
        solver._solve_tier(poses, _gen(), 3, 1e-3, 0.1, 3, 0.1, 0.75)  # another damping: another graph
        solver.generate_ik_solutions(poses, generator=_gen(), allow_uninitialized=True)
    solver.generate_ik_solutions(poses[:3], generator=_gen(), allow_uninitialized=True)  # called once
    assert len(graphs) == 3 and len(graphs._seen) == 1
    old = list(graphs.backend.graphs)
    new_params = [{k: [{n: t * 0.5 for n, t in lay.items()} for lay in blk[k]] for k in blk} for blk in solver.params]
    solver.set_params(new_params)
    assert solver.weights_version == version + 1
    assert len(graphs) == 0 and not graphs._seen and all(g.was_reset for g in old)
    # The next calls capture afresh on the new weights and equal the eager path there.
    got = [solver._solve_tier(poses, _gen(), 3, *TOL) for _ in range(WARMUP_CALLS + 1)]
    assert list(graphs._entries) == [("tier", 8, 3) + TOL + (version + 1, CPU)]
    monkeypatch.undo()
    ref = solver._solve_tier(poses, _gen(), 3, *TOL)
    for out in got:
        _equal(ref, out)


def test_capture_failure_raises_without_eager_fallback(monkeypatch):
    solver = _tiny_solver()
    poses = _reachable(8, seed=8)
    graphs = _stub_graphs(monkeypatch, solver, backend=StubBackend(fail_capture=True))
    calls = []
    program = solver._tier_program
    monkeypatch.setattr(solver, "_tier_program", lambda *a, **k: calls.append(1) or program(*a, **k))
    solver._solve_tier(poses, _gen(), 1, *TOL)  # the key's first call: eager
    with pytest.raises(RuntimeError, match="capturing"):
        solver._solve_tier(poses, _gen(), 1, *TOL)
    assert len(calls) == 2  # the eager call and the failed capture: no eager rerun
    assert len(graphs) == 0 and graphs.captures == 0
    solver.generate_ik_solutions(poses, generator=_gen(), allow_uninitialized=True)
    with pytest.raises(RuntimeError, match="capturing"):
        solver.generate_ik_solutions(poses, generator=_gen(), allow_uninitialized=True)


def test_cpu_tensors_never_enter_the_cache():
    solver = _tiny_solver()
    assert solver.use_graphs
    poses = _reachable(8, seed=9)
    solver.generate_exact_ik_solutions(poses, repeat_counts=(1, 2), generator=_gen(), allow_uninitialized=True)
    solver.generate_ik_solutions(poses, generator=_gen(), allow_uninitialized=True, return_detailed=True)
    solver.generate_diverse_ik_solutions(poses[0], 3, generator=_gen(), allow_uninitialized=True)
    fleet.solve_exact_megabatch(solver, poses, chunk_size=4, repeat_counts=(1, 2), allow_uninitialized=True)
    assert solver._graphs is None
    assert solver._graph_cache(poses) is None


# --------------------------------------------------------------------------
# On the card: the real graphs against the eager path.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the fused_mlp kernels have no CPU mode")
    return torch.device("cuda")


def _card_solver(cuda, bf16=False):
    hp = tiny_model_params()
    hp.bf16_hidden = bf16
    return IKFlowSolver(hp, get_robot("panda"), seed=0, device=cuda)


def _card_pair(cuda, bf16):
    graph = _card_solver(cuda, bf16)
    eager = IKFlowSolver(graph.hyper_parameters, graph.robot, params=graph.params, device=cuda)
    eager.use_graphs = False
    return graph, eager


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_card_exact_graph_equals_eager(cuda, bf16):
    graph, eager = _card_pair(cuda, bf16)
    poses = _reachable(64, seed=1).to(cuda)
    kw = dict(repeat_counts=(1, 3, 10), rot_error_threshold=0.01, allow_uninitialized=True, return_tier_counts=True)
    ref = eager.generate_exact_ik_solutions(poses, generator=torch.Generator(device=cuda).manual_seed(0), **kw)
    kernel = fused_mlp_bf16 if bf16 else fused_mlp
    tiers_run = 1 + sum(1 for c in ref[2][:-1] if c < 64)
    for call in range(3):  # eager, captured, replayed
        before = kernel.launches
        got = graph.generate_exact_ik_solutions(poses, generator=torch.Generator(device=cuda).manual_seed(0), **kw)
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        assert float((got[0] - ref[0]).abs().max()) <= 1e-6
        # the wrapper counts its own launches only: the eager call's, not a capture's or a replay's
        assert kernel.launches - before == (2 * graph.hyper_parameters.nb_nodes * tiers_run if call == 0 else 0)
    assert graph._graphs.captures == tiers_run and graph._graphs.replays == 2 * tiers_run


@pytest.mark.gpu
def test_card_approximate_and_diverse_graph_equal_eager(cuda):
    graph, eager = _card_pair(cuda, False)
    poses = _reachable(32, seed=2).to(cuda)
    for detailed in (False, True):
        a = eager.generate_ik_solutions(poses, generator=torch.Generator(device=cuda).manual_seed(1),
                                        allow_uninitialized=True, return_detailed=detailed)
        for _ in range(WARMUP_CALLS + 1):
            b = graph.generate_ik_solutions(poses, generator=torch.Generator(device=cuda).manual_seed(1),
                                            allow_uninitialized=True, return_detailed=detailed)
            _equal(a if detailed else (a,), b if detailed else (b,))
    a = eager.generate_diverse_ik_solutions(poses[0], 8, generator=torch.Generator(device=cuda).manual_seed(2),
                                            allow_uninitialized=True)
    for _ in range(WARMUP_CALLS + 1):
        b = graph.generate_diverse_ik_solutions(poses[0], 8, generator=torch.Generator(device=cuda).manual_seed(2),
                                                allow_uninitialized=True)
        assert torch.equal(a, b)
    assert graph._graphs.captures == 3


@pytest.mark.gpu
def test_card_set_params_recaptures_on_new_weights(cuda):
    graph, eager = _card_pair(cuda, False)
    poses = _reachable(16, seed=3).to(cuda)
    for _ in range(WARMUP_CALLS):
        graph.generate_ik_solutions(poses, allow_uninitialized=True)
    assert len(graph._graphs) == 1
    new = [{k: [{n: t * 0.9 for n, t in lay.items()} for lay in blk[k]] for k in blk} for blk in graph.params]
    graph.set_params(new)
    eager.set_params(new)
    assert len(graph._graphs) == 0
    latent = torch.randn((16, graph.network_width), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    ref = eager.generate_ik_solutions(poses, latent=latent)
    for _ in range(WARMUP_CALLS + 1):
        assert torch.equal(graph.generate_ik_solutions(poses, latent=latent), ref)
    assert len(graph._graphs) == 1
