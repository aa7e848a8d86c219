"""Data-parallel training in the port (``Trainer(mesh=...)``) on the CPU:
equal to the unsharded trainer with the same noise, its loss and gradients
held to the JAX package's sharded loss on its virtual 8-device mesh, the
refusal of a batch that does not divide, and two gloo processes whose
all-reduced gradients give the single-process two-entry mesh's parameters.

Tolerances: parameters within 1e-6 after 3 adamw steps (measured 6e-8: the
shards' gradients are summed in another order); the loss within 2e-5
relative of JAX's (``tests/test_sharding.py:33-43``) and the gradients within
1e-4 of the largest |g| (the bar of ``tests/test_torch_training.py``).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.parallel import make_mesh as jax_make_mesh, shard_batch as jax_shard_batch
from ikflow_tpu.training.loss import make_loss_fn as jax_make_loss_fn
from ikflow_tpu_torch.parallel.mesh import make_mesh
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.training import IkDataset, TrainConfig, Trainer
from ikflow_tpu_torch.training.checkpoints import flatten_params
from ikflow_tpu_torch.training.common import tree_leaves
from test_torch_training import batch, flow_pair, jax_flat, jax_noise

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def _dataset(n=256):
    q, poses = batch(n, seed=3)
    return IkDataset(q, poses, q[:32], poses[:32], "panda")


@pytest.mark.parametrize("fit", ["fit", "fit_on_device"])
def test_mesh_trainer_equals_unsharded(fit):
    """3 steps of Trainer(mesh=[cpu] * 4) against the unsharded trainer:
    both draw the same noise (the mesh draws over the whole batch before
    splitting it), so the parameters agree within 1e-6."""
    _, _, flow, params = flow_pair(8, False, True)
    robot = get_robot("panda")
    cfg = TrainConfig(n_steps=3, batch_size=64, log_every=1, eval_every=0, checkpoint_every=0)
    out = []
    for mesh in (None, make_mesh([CPU] * 4)):
        trainer = Trainer(flow, robot, cfg, device="cpu", mesh=mesh)
        kwargs = {"steps_per_call": 3} if fit == "fit_on_device" else {}
        out.append(getattr(trainer, fit)(params, _dataset(), **kwargs))
    (p1, m1), (p2, m2) = out
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(m1["tr/loss"], m2["tr/loss"], rtol=1e-6)


def test_loss_and_grads_match_jax_sharded():
    """The port's mesh step (4 CPU entries) against JAX's loss on inputs
    sharded over its 8 virtual devices, with JAX's draws as the noise."""
    jflow, jparams, flow, params = flow_pair(8, False, True)
    robot = get_robot("panda")
    q, poses = batch(64)
    key = jax.random.PRNGKey(2)
    jloss_fn = jax_make_loss_fn(jflow, 7)
    qs, ps = jax_shard_batch(jax_make_mesh(), jnp.asarray(q), jnp.asarray(poses))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jparams, key, qs, ps)
    trainer = Trainer(flow, robot, TrainConfig(batch_size=64), device="cpu", mesh=make_mesh([CPU] * 4))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics, grads = trainer.loss_and_grads(params, leaves, torch.from_numpy(q), torch.from_numpy(poses),
                                                  noise=jax_noise(key, 64, flow))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    np.testing.assert_allclose(float(metrics["tr/loss_ml"]), float(jloss), rtol=2e-5)
    jg = jax_flat(jgrads)
    gmax = max(np.abs(g).max() for g in jg.values())
    for key_, g in zip(flatten_params(params), grads):
        np.testing.assert_allclose(g.numpy(), jg[key_], atol=1e-4 * gmax, rtol=0, err_msg=key_)


def test_indivisible_batch_is_refused():
    _, _, flow, params = flow_pair(8, False, True)
    robot = get_robot("panda")
    trainer = Trainer(flow, robot, TrainConfig(n_steps=1, batch_size=30), device="cpu", mesh=make_mesh([CPU] * 4))
    with pytest.raises(ValueError, match=r"batch_size \(30\) must be divisible by the mesh size \(4\) to shard the "
                                         r"batch axis"):
        trainer.fit(params, _dataset())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_a_two_entry_mesh(tmp_path):
    """Two processes over loopback (gloo), each on a one-entry CPU mesh
    with its half of the batch, all-reduce their gradients: both ranks end
    with the parameters of one process on a two-entry mesh (within 1e-6).
    Each rank has 120 s; a hung rendezvous fails the test."""
    sys.path.insert(0, HERE)
    import torch_dp_worker

    ref_leaves, ref_losses = torch_dp_worker.run(2)
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_worker.py"),
                                       str(tmp_path / f"rank{rank}.pt")], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=True)
        assert got["rank"] == rank
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-6)
        for a, b in zip(got["leaves"], ref_leaves):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
