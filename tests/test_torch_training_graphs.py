"""The trainer's captured programs (the update step, the resident window's
step, validation) on the CPU, and on the card where there is one.

A ``torch.cuda.CUDAGraph`` cannot run here, so a run's cache is driven
through the stub backend of ``tests/test_torch_graphs.py``, whose graph
reruns the program on its static buffers. A training step changes state, and
a CUDA capture runs nothing (the replay after it runs the step once), so
``StepStub`` skips the replay that follows its capture, whose own run of the
program stands for it. Through it the trainer's graph path (draws made
outside and handed in as inputs, the optimizer's scalars filled before each
call, a key's eager first call, its capture, the replays) runs on the CPU,
and must equal the eager path bit for bit: both run the same operations on
the same numbers. A program that changed host state would pass the stub and
not the card: ``test_draws_in_graph_order_equal_generator_draws`` shows that
the step's program leaves the count and the generator alone.

Against the JAX package: the resident window's step, replayed 4 times with
the draws of ``_build_scan_steps``'s scan body injected, against that scan,
at the tolerances of ``test_three_steps_match_jax``: the losses within 1e-5
relative, the parameters within 1e-6 absolute.

Card tests (marked ``gpu``; they skip without CUDA) hold the real graphs to
the eager path on the card:

    python -m pytest tests/test_torch_training_graphs.py -m gpu --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from ikflow_tpu_torch.flow import FlowHyperParams, build_flow, fused_mlp, fused_mlp_bf16, tiny_model_params
from ikflow_tpu_torch.graphs import GraphCache
from ikflow_tpu_torch.parallel.mesh import make_mesh
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.training import IkDataset, TrainConfig, Trainer
from ikflow_tpu_torch.training.checkpoints import restore_checkpoint
from ikflow_tpu_torch.training.common import tree_leaves
from ikflow_tpu_torch.training.trainer import _trainable
from test_torch_graphs import StubBackend

CPU = torch.device("cpu")
N_STEPS = 13  # Lookahead syncs at 6 and 12; RAdam rectifies from step 6


class StepStub(StubBackend):
    """``StubBackend`` for programs that change state: its capture runs the
    program, and that run stands for the replay that follows the capture."""

    def capture(self, fn, args):
        graph, out = super().capture(fn, args)
        graph.captured_run = True
        return graph, out

    def replay(self, graph):
        if graph.__dict__.pop("captured_run", False):
            return
        graph.replay()


@pytest.fixture
def stub_caches(monkeypatch):
    """Route every run's programs on the CPU through a stub-backed cache;
    -> the caches made, in order."""
    caches = []

    def new_graphs(self):
        if not self.use_graphs or self.mesh is not None:
            return None
        caches.append(GraphCache(self.device, backend=StepStub()))
        return caches[-1]

    monkeypatch.setattr(Trainer, "_new_graphs", new_graphs)
    return caches


def _flow(D=9, softflow=True, sigmoid=False, bf16=False):
    hp = tiny_model_params()
    hp.dim_latent_space, hp.softflow_enabled, hp.sigmoid_on_output = D, softflow, sigmoid
    hp.coeff_fn_internal_size, hp.bf16_hidden = 64, bf16
    flow = build_flow(hp, get_robot("panda"))
    return flow, flow.init(torch.Generator().manual_seed(0))


def _dataset(n=512, n_te=32, seed=3):
    """n numpy-seeded in-limit configs and their poses. (This module imports
    no JAX at its top: the card's machine has none.)"""
    robot = get_robot("panda")
    rng = np.random.default_rng(seed)
    low, high = robot.limits_low().numpy(), robot.limits_high().numpy()
    q = (low + rng.uniform(size=(n + n_te, 7)) * (high - low)).astype(np.float32)
    poses = robot.forward_kinematics(torch.from_numpy(q)).numpy()
    return IkDataset(q[:n], poses[:n], q[n:], poses[n:], "panda")


def _trainer(flow, cfg, seen, graphs, device=CPU):
    tr = Trainer(flow, get_robot("panda"), cfg, metric_hook=lambda s, m: seen.append((s, m)), device=device)
    tr.use_graphs = graphs
    return tr


def _logged(seen):
    """The logged metrics without the wall-clock rate."""
    return [(s, {k: v for k, v in m.items() if k != "tr/batches_p_sec"}) for s, m in seen]


def _run(flow, params, ds, cfg, graphs, on_device, device=CPU, **kw):
    """One fit (or fit_on_device in one window): -> (params, optimizer
    state, logged metrics). The optimizer's state is read from its last
    checkpoint."""
    seen = []
    tr = _trainer(flow, cfg, seen, graphs, device)
    states = []
    tr._checkpoint = lambda d, step, p, opt: states.append({k: v for k, v in opt.state_dict().items()})
    if on_device:
        out, _ = tr.fit_on_device(params, ds, checkpoint_dir="unused", steps_per_call=kw.get("window", N_STEPS))
    else:
        out, _ = tr.fit(params, ds, checkpoint_dir="unused")
    return out, states[-1], _logged(seen)


def _state_leaves(state):
    if "core" in state:
        return [t for i in sorted(state["core"]["state"]) for k, t in sorted(state["core"]["state"][i].items())]
    return [t for k in ("m", "v", "slow") for t in state[k]]


def _assert_same_run(a, b):
    (pa, sa, la), (pb, sb, lb) = a, b
    for x, y in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(x, y)
    assert sa["count"] == sb["count"]
    for x, y in zip(_state_leaves(sa), _state_leaves(sb)):
        assert torch.equal(x, y)
    assert la == lb and la


# --------------------------------------------------------------------------
# The step: graph against eager.

@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("clip", ["value", "norm"])
@pytest.mark.parametrize("name", ["adamw", "adam", "adadelta", "ranger"])
def test_step_graph_equals_eager(stub_caches, name, clip, warmup):
    """``fit_on_device`` and ``fit`` through the cache equal the eager path
    bit for bit over 13 steps: parameters, optimizer state, logged metrics."""
    flow, params = _flow()
    ds = _dataset()
    cfg = TrainConfig(optimizer=name, gradient_clip_algorithm=clip, warmup_steps=warmup, step_lr_every=4,
                      gamma=0.5, learning_rate=1e-3, batch_size=32, n_steps=N_STEPS, log_every=1, eval_every=0,
                      checkpoint_every=0)
    for on_device in (True, False):
        eager = _run(flow, params, ds, cfg, False, on_device)
        graph = _run(flow, params, ds, cfg, True, on_device)
        _assert_same_run(graph, eager)
        cache = stub_caches[-1]
        assert cache.captures == 1 and cache.replays == N_STEPS - 1
    assert len(stub_caches) == 2 and all(len(c) == 0 for c in stub_caches)  # each emptied at its run's end


def test_step_graph_equals_eager_without_noise(stub_caches):
    """panda__full__sigmoid's shape: D = ndof under the sigmoid head, no
    softflow, so the step draws no noise and the graph's only input is the
    batch."""
    flow, params = _flow(D=7, softflow=False, sigmoid=True)
    ds = _dataset()
    cfg = TrainConfig(batch_size=32, n_steps=6, log_every=1, eval_every=0, checkpoint_every=0, learning_rate=1e-3)
    for on_device in (True, False):
        _assert_same_run(_run(flow, params, ds, cfg, True, on_device, window=3),
                         _run(flow, params, ds, cfg, False, on_device, window=3))


# --------------------------------------------------------------------------
# Validation.

@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_validation_graph_equals_eager(stub_caches, bf16):
    """Three validations in one run's scope through the cache equal eager,
    with the parameters changed in place between them (as the optimizer
    changes them): one capture serves every later validation of the run."""
    flow, params = _flow(D=8, softflow=False, sigmoid=True, bf16=bf16)
    ds = _dataset(n=64)
    cfg = TrainConfig(val_set_size=8, samples_per_pose=6)
    out = {}
    for graphs in (False, True):
        p = _trainable(params)
        tr = _trainer(flow, cfg, [], graphs)
        with tr.graph_scope() as cache:
            vals = []
            for i in range(3):
                vals.append(tr.validate(p, ds, torch.Generator().manual_seed(i)))
                with torch.no_grad():
                    for t in tree_leaves(p):
                        t.mul_(0.9)
            out[graphs] = vals
        if graphs:
            assert cache.captures == 1 and cache.replays == 2 and len(cache) == 0
        else:
            assert cache is None
    assert out[True] == out[False]
    assert len({v["val/l2_error_mm"] for v in out[True]}) == 3


def test_validation_graph_follows_the_parameters_it_is_given(stub_caches):
    """Other parameter tensors in the same scope are another key: never a
    replay of a graph that reads the first ones."""
    flow, params = _flow(D=8, softflow=False, sigmoid=True)
    ds = _dataset(n=64)
    tr = _trainer(flow, TrainConfig(val_set_size=4, samples_per_pose=4), [], True)
    a, b = _trainable(params), _trainable(tuple({k: [{n: 0.5 * t for n, t in lay.items()} for lay in blk[k]]
                                                 for k in blk} for blk in params))
    ref = Trainer(flow, get_robot("panda"), tr.config, device=CPU).validate(b, ds, torch.Generator().manual_seed(1))
    with tr.graph_scope() as cache:
        for _ in range(2):
            tr.validate(a, ds, torch.Generator().manual_seed(1))
        assert tr.validate(b, ds, torch.Generator().manual_seed(1)) == ref
        assert cache.captures == 1 and cache.replays == 1


# --------------------------------------------------------------------------
# Draws.

def test_draws_in_graph_order_equal_generator_draws():
    """The resident step's draws made outside its program, in the graph
    path's order (the batch indices, then ``LossFn.draw``), equal the draws
    the eager step made inside from the same generator, bit for bit; and the
    program itself leaves the optimizer's count and the generator alone."""
    flow, params = _flow()
    ds = _dataset()
    tr = Trainer(flow, get_robot("panda"), TrainConfig(batch_size=32), device=CPU)
    samples, endpoints = torch.from_numpy(ds.samples_tr), torch.from_numpy(ds.endpoints_tr)
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, ds.n_train, (32,), generator=g)
    loss_in, _ = tr.loss_fn(params, samples[idx], endpoints[idx], generator=g)
    g = torch.Generator().manual_seed(5)
    idx2 = torch.randint(0, ds.n_train, (32,), generator=g)
    noise = tr._noise_inputs(tr.loss_fn.draw(samples.new_empty((32, 7)), g))
    assert torch.equal(idx, idx2) and len(noise) == 3
    loss_out, _ = tr.loss_fn(params, samples[idx2], endpoints[idx2], noise=tr._noise(noise))
    assert torch.equal(loss_in, loss_out)

    p = _trainable(params)
    opt = tr.make_optimizer(p)
    step = tr._stepper(("window", 32), p, opt, samples, endpoints, with_metrics=False)
    state = g.get_state()
    (loss,) = step(idx2, *noise)
    assert opt.count == 1 and torch.equal(g.get_state(), state)
    assert torch.equal(loss, loss_out.detach())


# --------------------------------------------------------------------------
# Against JAX: the window with the scan's own draws.

def test_window_with_jax_draws_matches_jax_scan():
    import jax
    import jax.numpy as jnp

    from ikflow_tpu.robots import get_robot as jax_get_robot
    from ikflow_tpu.training import TrainConfig as JaxTrainConfig, Trainer as JaxTrainer
    from ikflow_tpu_torch.training.checkpoints import flatten_params
    from test_torch_training import flow_pair, jax_flat, jax_noise

    S, B = 4, 64
    jflow, jparams, flow, params = flow_pair(9, False, True)
    ds = _dataset(n=512)
    jtr = JaxTrainer(jflow, jax_get_robot("panda"), JaxTrainConfig(batch_size=B))
    key = jax.random.PRNGKey(11)
    jout = jtr._build_scan_steps(ds.n_train, S)(jparams, jtr.optimizer.init(jparams), key,
                                                jnp.asarray(ds.samples_tr), jnp.asarray(ds.endpoints_tr))
    jparams_out, jmean, jlast = jout[0], float(jout[3]), float(jout[4])

    tr = Trainer(flow, get_robot("panda"), TrainConfig(batch_size=B), device=CPU)
    p = _trainable(params)
    opt = tr.make_optimizer(p)
    cache = tr._graphs = GraphCache(CPU, backend=StepStub())
    step = tr._stepper(("window",), p, opt, torch.from_numpy(ds.samples_tr), torch.from_numpy(ds.endpoints_tr),
                       with_metrics=False)
    losses = []
    for _ in range(S):  # the scan body's draws
        key, kb, kl = jax.random.split(key, 3)
        idx = torch.from_numpy(np.asarray(jax.random.randint(kb, (B,), 0, ds.n_train)).astype(np.int64))
        losses.append(float(step(idx, *tr._noise_inputs(jax_noise(kl, B, flow)))[0]))
    assert cache.captures == 1 and cache.replays == S - 1
    np.testing.assert_allclose(np.mean(losses), jmean, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(losses[-1], jlast, rtol=1e-5, atol=1e-7)
    jflat = jax_flat(jparams_out)
    for key_, leaf in flatten_params(p).items():
        np.testing.assert_allclose(leaf, jflat[key_], atol=1e-6, rtol=0, err_msg=key_)


# --------------------------------------------------------------------------
# The cache's lifetime, resume, no fallback, the paths that never capture.

def test_cache_is_reset_when_a_fit_returns_or_raises(stub_caches):
    flow, params = _flow()
    ds = _dataset()
    cfg = TrainConfig(batch_size=32, n_steps=6, log_every=1, eval_every=3, checkpoint_every=0,
                      val_set_size=4, samples_per_pose=4)
    tr = _trainer(flow, cfg, [], True)
    tr.fit_on_device(params, ds, steps_per_call=3)
    cache = stub_caches[-1]
    assert cache.captures == 2 and len(cache) == 0 and tr._graphs is None  # the step and the validation
    assert all(g.was_reset for g in cache.backend.graphs)

    def stop(step, metrics):
        if step >= 3:
            raise KeyboardInterrupt

    tr.metric_hook = stop
    with pytest.raises(KeyboardInterrupt):
        tr.fit(params, ds)
    cache = stub_caches[-1]
    assert cache.captures == 1 and len(cache) == 0 and tr._graphs is None
    assert all(g.was_reset for g in cache.backend.graphs)


def test_load_state_dict_keeps_the_addresses():
    flow, params = _flow()
    for name in ("adamw", "adadelta", "ranger"):
        p = _trainable(params)
        tr = Trainer(flow, get_robot("panda"), TrainConfig(optimizer=name), device=CPU)
        opt = tr.make_optimizer(p)
        other = tr.make_optimizer(_trainable(params))
        for t in tree_leaves(other.params):
            t.grad = torch.ones_like(t)
        for _ in range(3):
            other.step()
        ptrs = [t.data_ptr() for ts in opt._state.values() for t in ts] + [
            t.data_ptr() for t in opt._scalars.values()]
        opt.load_state_dict(other.state_dict())
        assert ptrs == [t.data_ptr() for ts in opt._state.values() for t in ts] + [
            t.data_ptr() for t in opt._scalars.values()]
        assert opt.count == 3
        for a, b in zip(_state_leaves(opt.state_dict()), _state_leaves(other.state_dict())):
            assert torch.equal(a, b)


def test_checkpoint_from_the_graph_path_resumes_on_the_eager_path(stub_caches, tmp_path):
    """A run on the graphs writes the eager run's checkpoint; resumed from
    it, the eager path and the graph path continue equal."""
    flow, params = _flow()
    ds = _dataset()
    cfg = TrainConfig(optimizer="ranger", batch_size=32, n_steps=8, log_every=0, eval_every=0, checkpoint_every=0)
    ckpts = {}
    for graphs in (True, False):
        ckpts[graphs] = str(tmp_path / f"graphs_{graphs}")
        _trainer(flow, cfg, [], graphs).fit_on_device(params, ds, checkpoint_dir=ckpts[graphs], steps_per_call=4)
    restored, step = restore_checkpoint(ckpts[True])
    eager_restored, _ = restore_checkpoint(ckpts[False])
    assert step == 8 and restored["opt_state"]["count"] == 8
    for a, b in zip(tree_leaves(restored["params"]) + _state_leaves(restored["opt_state"]),
                    tree_leaves(eager_restored["params"]) + _state_leaves(eager_restored["opt_state"])):
        assert torch.equal(a, b)
    cfg2 = dataclasses.replace(cfg, n_steps=N_STEPS, log_every=1)
    runs = []
    for graphs in (False, True):
        seen = []
        out, _ = _trainer(flow, cfg2, seen, graphs).fit(restored["params"], ds, start_step=step,
                                                        opt_state=restored["opt_state"])
        runs.append((out, _logged(seen)))
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)
    assert runs[0][1] == runs[1][1] and len(runs[0][1]) == N_STEPS - step


def test_capture_failure_raises_without_eager_fallback(monkeypatch):
    flow, params = _flow()
    ds = _dataset()
    monkeypatch.setattr(Trainer, "_new_graphs", lambda self: GraphCache(self.device, backend=StubBackend(True)))
    calls = []
    forward = flow.forward
    monkeypatch.setattr(flow, "forward", lambda *a: calls.append(1) or forward(*a))
    tr = _trainer(flow, TrainConfig(batch_size=32, n_steps=4, eval_every=0, checkpoint_every=0), [], True)
    with pytest.raises(RuntimeError, match="capturing"):
        tr.fit_on_device(params, ds, steps_per_call=4)
    assert len(calls) == 2 and tr._graphs is None  # the eager first step and the failed capture: no rerun


def test_mesh_and_cpu_never_enter_a_cache(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a cache ran a program")

    monkeypatch.setattr(GraphCache, "run", refuse)
    flow, params = _flow()
    ds = _dataset()
    cfg = TrainConfig(batch_size=32, n_steps=3, log_every=1, eval_every=3, checkpoint_every=0,
                      val_set_size=4, samples_per_pose=4)
    plain = _trainer(flow, cfg, [], True)
    mesh = Trainer(flow, get_robot("panda"), cfg, mesh=make_mesh([CPU, CPU]))
    for tr in (plain, mesh):
        assert tr.use_graphs and tr._new_graphs() is None
        tr.fit_on_device(params, ds, steps_per_call=3)
        tr.fit(params, ds)
    # On a card's device a mesh gets the run's cache, as one device does.
    mesh.device = torch.device("cuda")
    assert isinstance(mesh._new_graphs(), GraphCache)


# --------------------------------------------------------------------------
# On the card: the real graphs against the eager path.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the fused_mlp kernels have no CPU mode")
    return torch.device("cuda")


def _card_dataset(cuda, n=4096):
    from ikflow_tpu_torch.training import build_dataset_resident

    return build_dataset_resident(get_robot("panda"), training_set_size=n, test_set_size=64, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["value", "norm"])
@pytest.mark.parametrize("name", ["adamw", "adam", "adadelta", "ranger"])
def test_card_step_graph_equals_eager(cuda, name, clip):
    """fit_on_device and fit on the card, 13 steps of a tiny flow with
    softflow and pad noise, graphs against eager: equal bit for bit."""
    flow, _ = _flow()
    params = flow.init(torch.Generator(device=cuda).manual_seed(0))
    ds = _card_dataset(cuda)
    cfg = TrainConfig(optimizer=name, gradient_clip_algorithm=clip, step_lr_every=4, gamma=0.5, learning_rate=1e-3,
                      batch_size=256, n_steps=N_STEPS, log_every=1, eval_every=0, checkpoint_every=0)
    for on_device in (True, False):
        _assert_same_run(_run(flow, params, ds, cfg, True, on_device, cuda),
                         _run(flow, params, ds, cfg, False, on_device, cuda))


@pytest.mark.gpu
def test_card_full_width_fp32_step_graph_equals_eager(cuda):
    """panda__full__sigmoid's architecture at full width, batch 512: three
    resident steps on the graphs equal three eager steps bit for bit."""
    from ikflow_tpu_torch.registry import model_descriptions

    hp = FlowHyperParams.from_dict(model_descriptions()["panda__full__sigmoid"])
    flow = build_flow(hp, get_robot("panda"))
    params = flow.init(torch.Generator(device=cuda).manual_seed(0))
    ds = _card_dataset(cuda, 65536)
    cfg = TrainConfig(batch_size=512, n_steps=3, log_every=1, eval_every=0, checkpoint_every=0)
    _assert_same_run(_run(flow, params, ds, cfg, True, True, cuda, window=3),
                     _run(flow, params, ds, cfg, False, True, cuda, window=3))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["k1", "k1b"])
def test_card_validation_graph_equals_eager(cuda, bf16):
    """Three validations on the graphs equal eager; the wrapper counts the
    eager first call's launches only."""
    flow, _ = _flow(D=8, softflow=False, sigmoid=True, bf16=bf16)
    params = _trainable(flow.init(torch.Generator(device=cuda).manual_seed(0)))
    ds = _card_dataset(cuda)
    cfg = TrainConfig(val_set_size=16, samples_per_pose=8)
    kernel = fused_mlp_bf16 if bf16 else fused_mlp
    ref = [Trainer(flow, get_robot("panda"), cfg, device=cuda).validate(
        params, ds, torch.Generator(device=cuda).manual_seed(i)) for i in range(3)]
    tr = Trainer(flow, get_robot("panda"), cfg, device=cuda)
    with tr.graph_scope() as cache:
        for i in range(3):
            before = kernel.launches
            assert tr.validate(params, ds, torch.Generator(device=cuda).manual_seed(i)) == ref[i]
            assert kernel.launches - before == (2 * flow.hp.nb_nodes if i == 0 else 0)
        assert cache.captures == 1 and cache.replays == 2
