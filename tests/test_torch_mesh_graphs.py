"""The data-parallel trainer's captured programs (``Trainer(mesh=...)``,
``training/trainer.py::_MeshStep``) on the CPU.

A ``torch.cuda.CUDAGraph`` cannot run here, so each run's cache is driven
through ``StepStub`` (``tests/test_torch_training_graphs.py``), whose
capture's own run of the program stands for the replay after it. Through it
the mesh's graph path (the draws outside, the optimizer's scalars filled
before each call, a key's eager first call, its capture, the replays) must
equal the eager mesh path bit for bit: both run the same programs.

- One card: every entry on one device, one program holds the whole step.
- Two cards: ``cpu:0`` and ``cpu:1`` stand for two cards (two devices that
  compare unequal), so the step splits into a program per card, with the
  copies across them between the replays; the stub records the device of
  each capture and replay. The routing of a second card's programs to a
  ``CudaBackend`` of that card is checked on a fake two-card
  ``torch.cuda`` (``tests/test_torch_streams.py``).
- Two ranks: two gloo processes over loopback
  (``tests/torch_mesh_graphs_worker.py``), where the all-reduce runs
  between the gradient's program and the update's.

Against the JAX package: the mesh's step on the graphs, with JAX's draws as
the noise, against JAX's sharded step on a 2-device mesh of the virtual CPU
devices, at the tolerances of ``test_torch_data_parallel.py`` and
``test_torch_training_steps.py``: the loss within 2e-5 relative, the
gradient statistics within 1e-4 relative, the parameters after 3 steps
within 1e-6 absolute.
"""

import contextlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ikflow_tpu_torch.graphs import CudaBackend, GraphCache
from ikflow_tpu_torch.parallel.mesh import make_mesh
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.training import TrainConfig, Trainer
from ikflow_tpu_torch.training.common import tree_leaves
from ikflow_tpu_torch.training.trainer import STEP_METRICS, _trainable
from test_torch_streams import FakeCuda
from test_torch_training_graphs import StepStub, _assert_same_run, _dataset, _flow, _logged

CPU = torch.device("cpu")
CARD0, CARD1 = torch.device("cpu", 0), torch.device("cpu", 1)
HERE = os.path.dirname(os.path.abspath(__file__))
N_STEPS = 13  # Lookahead syncs at 6 and 12; RAdam rectifies from step 6


class CardStub(StepStub):
    """``StepStub`` of one device that logs ("capture" | "replay", device)
    into ``log``; ``for_device`` gives another device's stub on the same
    log. ``fail_on``: the device whose capture raises."""

    def __init__(self, device, log, fail_on=None):
        super().__init__(fail_capture=device == fail_on)
        self.device, self.log, self.fail_on = device, log, fail_on

    def for_device(self, device):
        return CardStub(device, self.log, self.fail_on)

    def capture(self, fn, args):
        self.log.append(("capture", self.device))
        return super().capture(fn, args)

    def replay(self, graph):
        self.log.append(("replay", self.device))
        super().replay(graph)


@pytest.fixture
def mesh_caches(monkeypatch):
    """Route every run's programs through a ``CardStub``-backed cache, on a
    mesh too; -> (the caches made, in order, the log of their backends)."""
    caches, log = [], []

    def new_graphs(self):
        if not self.use_graphs:
            return None
        caches.append(GraphCache(self.device, backend=CardStub(self.device, log)))
        return caches[-1]

    monkeypatch.setattr(Trainer, "_new_graphs", new_graphs)
    return caches, log


def _run(flow, params, ds, cfg, graphs, on_device, mesh, window=N_STEPS):
    """One fit (or fit_on_device in windows of ``window``) on ``mesh``: ->
    (params, optimizer state, logged metrics)."""
    seen, states = [], []
    tr = Trainer(flow, get_robot("panda"), cfg, metric_hook=lambda s, m: seen.append((s, m)), device=CPU, mesh=mesh)
    tr.use_graphs = graphs
    tr._checkpoint = lambda d, step, p, opt: states.append(dict(opt.state_dict()))
    if on_device:
        out, _ = tr.fit_on_device(params, ds, checkpoint_dir="unused", steps_per_call=window)
    else:
        out, _ = tr.fit(params, ds, checkpoint_dir="unused")
    return out, states[-1], _logged(seen)


def _cfg(name="adamw", **kw):
    base = dict(optimizer=name, learning_rate=1e-3, batch_size=32, n_steps=N_STEPS, log_every=1, eval_every=0,
                checkpoint_every=0, step_lr_every=4, gamma=0.5)
    base.update(kw)
    return TrainConfig(**base)


# --------------------------------------------------------------------------
# One card: one program holds the step.

@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", ["adamw", "ranger"])
def test_one_card_mesh_graph_equals_eager(mesh_caches, name, bf16):
    """``fit_on_device`` and ``fit`` of a two-entry mesh on one device
    through the cache equal the eager mesh path bit for bit over 13 steps:
    one capture, one replay per later step, the cache emptied at the end."""
    caches, log = mesh_caches
    flow, params = _flow(bf16=bf16)
    ds = _dataset()
    mesh = make_mesh([CPU, CPU])
    for on_device in (True, False):
        eager = _run(flow, params, ds, _cfg(name), False, on_device, mesh)
        graph = _run(flow, params, ds, _cfg(name), True, on_device, mesh)
        _assert_same_run(graph, eager)
        cache = caches[-1]
        assert cache.captures == 1 and cache.replays == N_STEPS - 1 and len(cache) == 0
    assert {d for _, d in log} == {CPU}


def test_one_card_mesh_validation_replays_inside_the_run(mesh_caches):
    """Validation of a mesh run goes through the run's cache on the first
    entry: the windows' validations after the first replay one capture, and
    equal the eager run's."""
    caches, _ = mesh_caches
    flow, params = _flow(D=8, softflow=False, sigmoid=True)
    ds = _dataset()
    cfg = _cfg(n_steps=12, log_every=4, eval_every=4, val_set_size=4, samples_per_pose=4)
    mesh = make_mesh([CPU, CPU])
    _assert_same_run(_run(flow, params, ds, cfg, True, True, mesh, window=4),
                     _run(flow, params, ds, cfg, False, True, mesh, window=4))
    assert caches[-1].captures == 2 and caches[-1].replays == 12 - 1 + 2  # the step and the validation


# --------------------------------------------------------------------------
# Two cards: a program per card, the copies between the replays.

@pytest.mark.parametrize("devices", [(CARD0, CARD1), (CARD0, CARD1, CARD0, CARD1)], ids=["2x1", "2x2"])
@pytest.mark.parametrize("name", ["adamw", "ranger"])
def test_two_card_mesh_graph_equals_eager(mesh_caches, name, devices):
    """Entries on two cards: a graph per card, each captured and replayed on
    its own card; graph equals eager bit for bit, and both are within 1e-6
    of the unsharded step (the cards' gradients summed in another order)."""
    caches, log = mesh_caches
    flow, params = _flow()
    ds = _dataset()
    cfg = _cfg(name, batch_size=48)
    mesh = make_mesh(list(devices))
    for on_device in (True, False):
        log.clear()
        eager = _run(flow, params, ds, cfg, False, on_device, mesh)
        graph = _run(flow, params, ds, cfg, True, on_device, mesh)
        _assert_same_run(graph, eager)
        cache = caches[-1]
        assert cache.captures == 1 and cache.replays == N_STEPS - 1 and len(cache) == 0  # emptied with its run
        assert [d for kind, d in log if kind == "capture"] == [CARD1, CARD0]  # the second card's part first
        assert sum(1 for kind, d in log if kind == "replay" and d == CARD1) == N_STEPS - 1
        unsharded = _run(flow, params, ds, cfg, False, on_device, None)
        for a, b in zip(tree_leaves(graph[0]), tree_leaves(unsharded[0])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_second_card_runs_on_its_own_card(monkeypatch):
    """On a fake two-card ``torch.cuda``: ``GraphCache.on`` gives the second
    card a ``CudaBackend`` of that card, whose replays run with it current;
    emptying the run's cache resets the second card's graphs."""
    fake = FakeCuda()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    cache = GraphCache(torch.device("cuda", 0))
    other = cache.on(torch.device("cuda", 1))
    assert cache.on(torch.device("cuda", 0)) is cache and cache.on("cuda:1") is other
    assert isinstance(other.backend, CudaBackend) and other.backend.device == torch.device("cuda", 1)

    class FakeGraph:
        reset_called = False

        def replay(self):
            replayed.append(fake.current)

        def reset(self):
            self.reset_called = True

    replayed, graph = [], FakeGraph()
    other.backend.replay(graph)
    assert replayed == [1] and fake.current == 0
    other._entries["k"] = type("E", (), {"graph": graph})()
    cache.clear()
    assert graph.reset_called and len(other) == 0 and cache._others == {}


def test_two_card_capture_failure_raises_without_eager_fallback(monkeypatch):
    """A capture that fails on the second card raises, naming it: the step
    does not go on eagerly."""
    flow, params = _flow()
    ds = _dataset()
    log = []
    monkeypatch.setattr(Trainer, "_new_graphs", lambda self: GraphCache(self.device, backend=CardStub(
        self.device, log, fail_on=CARD1)))
    calls = []
    forward = flow.forward
    monkeypatch.setattr(flow, "forward", lambda *a: calls.append(1) or forward(*a))
    tr = Trainer(flow, get_robot("panda"), _cfg(n_steps=4), mesh=make_mesh([CARD0, CARD1]))
    with pytest.raises(RuntimeError, match="capturing"):
        tr.fit_on_device(params, ds, steps_per_call=4)
    # The first (eager) step ran both cards' forwards, the failed capture one more: nothing after it.
    assert len(calls) == 3 and tr._graphs is None and log == [("capture", CARD1)]


# --------------------------------------------------------------------------
# Against JAX's sharded step.

def test_mesh_graph_step_matches_jax_sharded(mesh_caches):
    """Three steps of the port's two-entry mesh on the graphs, with JAX's
    draws as the noise, against three of JAX's sharded steps on a 2-device
    mesh of virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from ikflow_tpu.parallel import make_mesh as jax_make_mesh, shard_batch as jax_shard_batch
    from ikflow_tpu.robots import get_robot as jax_get_robot
    from ikflow_tpu.training import TrainConfig as JaxTrainConfig, Trainer as JaxTrainer
    from ikflow_tpu_torch.training.checkpoints import flatten_params
    from test_torch_training import batch, flow_pair, jax_flat, jax_noise

    caches, _ = mesh_caches
    jflow, jparams, flow, params = flow_pair(9, False, True)
    jmesh = jax_make_mesh(jax.devices()[:2])
    jtr = JaxTrainer(jflow, jax_get_robot("panda"), JaxTrainConfig(batch_size=64), mesh=jmesh)
    jstate = jtr.optimizer.init(jparams)
    tr = Trainer(flow, get_robot("panda"), TrainConfig(batch_size=64), device="cpu", mesh=make_mesh([CPU, CPU]))
    p = _trainable(params)
    opt = tr.make_optimizer(p)
    with tr.graph_scope() as cache:
        step = tr._stepper(("fit", 64, True), p, opt)
        for i in range(3):
            q, poses = batch(64, seed=10 + i)
            key = jax.random.PRNGKey(20 + i)
            qs, ps = jax_shard_batch(jmesh, jnp.asarray(q), jnp.asarray(poses))
            jparams, jstate, jm = jtr._step_fn(jparams, jstate, key, qs, ps)
            noise = tr._noise_inputs(jax_noise(key, 64, flow))
            m = dict(zip(STEP_METRICS, (float(v) for v in step(torch.from_numpy(q), torch.from_numpy(poses), *noise))))
            for k in ("tr/loss", "tr/loss_ml"):
                np.testing.assert_allclose(m[k], float(jm[k]), rtol=2e-5, err_msg=k)
            for k in ("tr/grad_abs_ave", "tr/grad_max"):
                np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4, err_msg=k)
        assert cache is caches[-1] and cache.captures == 1 and cache.replays == 2
    jflat = jax_flat(jparams)
    for key_, leaf in flatten_params(p).items():
        np.testing.assert_allclose(leaf, jflat[key_], atol=1e-6, rtol=0, err_msg=key_)


# --------------------------------------------------------------------------
# Two ranks: the all-reduce between the replays.

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_on_the_graphs_equal_eager(tmp_path):
    """Two processes over loopback (gloo), each a two-entry mesh, train
    ``fit_on_device`` eagerly and then on stub graphs: on both ranks the two
    runs end with equal parameters and losses, bit for bit, and the graph
    run captured the gradient's program and the update's. 120 s per rank at
    most; a hung rendezvous fails the test."""
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mesh_graphs_worker.py"),
                                       str(tmp_path / f"rank{rank}.pt")], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    with contextlib.ExitStack() as stack:
        for p in procs:
            stack.callback(lambda p=p: p.poll() is None and (p.kill(), p.wait()))
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out
    got = [torch.load(tmp_path / f"rank{rank}.pt", weights_only=True) for rank in range(2)]
    for rank, g in enumerate(got):
        assert g["rank"] == rank and g["captures"] == 2 and g["eager_losses"] == g["graph_losses"]
        for a, b in zip(g["eager"], g["graph"]):
            assert torch.equal(a, b)
    for a, b in zip(got[0]["graph"], got[1]["graph"]):  # the ranks agree
        assert torch.equal(a, b)
