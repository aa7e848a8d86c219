"""Parity of the port's training loss, gradients, optimizers and LR schedule
with the JAX package, on the CPU.

The same numpy-seeded batch goes through both losses, with JAX's pad and
softflow draws reproduced from its key and passed to the port. Tolerances:
- loss and the 5 ``tr/*`` output metrics within 1e-5 relative, every
  gradient leaf within 1e-4 of the largest |g| (fp32 sums in another order;
  measured: 3.4e-7 and 1.4e-7);
- ``bf16_hidden``: both round the same operands and the same cotangents to
  bf16, but a value within an fp32 ulp of a bf16 rounding boundary can round
  the other way (one bf16 ulp, 2^-8 relative), so the loss and metrics are
  held to 1e-4 relative and the gradients to 1e-3 of the largest |g|
  (measured: 4.4e-6 and 7.2e-5);
- optimizers: 7 updates from the same parameters and the same numpy
  gradients as optax, parameters within 1e-6 absolute at lr 1e-4 and their
  displacement within 1e-3 of the largest displacement plus 8 float32 ulps
  of the parameter (the rounding of the parameter itself); the LR schedule
  equal to optax's at every count to 1e-7 relative (both float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ikflow_tpu.flow import build_flow as jax_build_flow, tiny_model_params as jax_tiny
from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu.training.loss import get_softflow_noise as jax_softflow_noise, make_loss_fn as jax_make_loss_fn
from ikflow_tpu.training.optimizers import make_lr_schedule as jax_make_lr_schedule
from ikflow_tpu.training.optimizers import make_optimizer as jax_make_optimizer
from ikflow_tpu_torch.flow import FlowHyperParams, build_flow
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.training import get_softflow_noise, make_loss_fn, make_optimizer
from ikflow_tpu_torch.training.checkpoints import flatten_params, params_from_jax
from ikflow_tpu_torch.training.common import tree_leaves
from ikflow_tpu_torch.training.optimizers import make_lr_schedule

METRICS = ("tr/output_max", "tr/output_abs_ave", "tr/output_ave", "tr/output_std", "tr/loss_ml")


def flow_pair(D, sigmoid, softflow, bf16=False, width=64):
    """The JAX flow and the port's on the same hyperparameters and weights:
    (jax flow, jax params, port flow, port params)."""
    hp = jax_tiny()
    hp.dim_latent_space, hp.sigmoid_on_output, hp.softflow_enabled = D, sigmoid, softflow
    hp.coeff_fn_internal_size, hp.bf16_hidden = width, bf16
    jflow = jax_build_flow(hp, jax_get_robot("panda"))
    jparams = jflow.init(jax.random.PRNGKey(0))
    flow = build_flow(FlowHyperParams.from_dict(hp.to_dict()), get_robot("panda"))
    return jflow, jparams, flow, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def batch(n, seed=1):
    """n in-limit Panda configs (numpy-seeded) and their FK poses."""
    robot = get_robot("panda")
    rng = np.random.default_rng(seed)
    low, high = robot.limits_low().numpy(), robot.limits_high().numpy()
    q = (low + rng.uniform(size=(n, 7)) * (high - low)).astype(np.float32)
    return q, robot.forward_kinematics(torch.from_numpy(q)).numpy()


def jax_flat(tree):
    """JAX pytree -> {"<block>/<s1|s2>/<layer>/<w|b>": numpy}, the deploy keys."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_noise(key, n, flow):
    """JAX's draws inside ``loss_fn(params, key, ...)``, as the port's noise."""
    kpad, ksf = jax.random.split(key)
    pad = c = v = None
    if flow.D > flow.ndof:
        pad = torch.from_numpy(np.array(0.001 * jax.random.normal(kpad, (n, flow.D - flow.ndof))))
    if flow.hp.softflow_enabled:
        jc, jv = jax_softflow_noise(ksf, jnp.zeros((n, flow.D)), flow.hp.softflow_noise_scale)
        c, v = torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(jv))
    return pad, c, v


@pytest.mark.parametrize("D,sigmoid,softflow,bf16", [
    (7, True, False, False),  # sigmoid head, D = ndof: panda__full__sigmoid's shape
    (9, False, True, False),  # softflow, D > ndof
    (9, True, True, True),  # bf16_hidden, with pads under the sigmoid head and softflow
], ids=["sigmoid_D7", "softflow_D9", "bf16_hidden"])
def test_loss_and_grads_match_jax(D, sigmoid, softflow, bf16):
    jflow, jparams, flow, params = flow_pair(D, sigmoid, softflow, bf16)
    q, poses = batch(96)
    key = jax.random.PRNGKey(5)
    jloss_fn = jax_make_loss_fn(jflow, 7)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(jparams, key, jnp.asarray(q),
                                                                           jnp.asarray(poses))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = make_loss_fn(flow, 7)(params, torch.from_numpy(q), torch.from_numpy(poses),
                                          noise=jax_noise(key, 96, flow))
    grads = torch.autograd.grad(loss, leaves)
    loss_rtol, grad_share = (1e-4, 1e-3) if bf16 else (1e-5, 1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=loss_rtol)
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=loss_rtol, atol=1e-7, err_msg=k)
    jg = jax_flat(jgrads)
    gmax = max(np.abs(g).max() for g in jg.values())
    assert gmax > 0 and len(jg) == len(grads)
    for key_, g in zip(flatten_params(params), grads):
        np.testing.assert_allclose(g.numpy(), jg[key_], atol=grad_share * gmax, rtol=0, err_msg=key_)


def test_loss_draws_from_generator_and_refuses_no_randomness():
    _, _, flow, params = flow_pair(9, False, True)
    q, poses = (torch.from_numpy(a) for a in batch(32))
    loss_fn = make_loss_fn(flow, 7)
    a = loss_fn(params, q, poses, generator=torch.Generator().manual_seed(3))[0]
    b = loss_fn(params, q, poses, generator=torch.Generator().manual_seed(3))[0]
    c = loss_fn(params, q, poses, generator=torch.Generator().manual_seed(4))[0]
    assert float(a) == float(b) and float(a) != float(c)
    with pytest.raises(ValueError, match="generator or the noise"):
        loss_fn(params, q, poses)


def test_softflow_noise_semantics():
    c, v = get_softflow_noise(torch.zeros((4000, 9)), 0.01, torch.Generator().manual_seed(0))
    assert c.shape == (4000, 1) and v.shape == (4000, 9)
    assert bool((c >= 0).all() and (c <= 1).all())
    ratio = v.abs().mean(dim=1)
    assert float(ratio[c[:, 0] > 0.8].mean()) > 3 * float(ratio[c[:, 0] < 0.2].mean())


def test_pad_is_clipped_under_the_sigmoid_head():
    """A pad draw beyond the sigmoid head's range is clipped just inside it,
    as in JAX (an unclipped 2.0 would hit the head's 1e-7 clamp)."""
    _, _, flow, params = flow_pair(8, True, False)
    q, poses = (torch.from_numpy(a) for a in batch(4))
    loss_fn = make_loss_fn(flow, 7)
    big = loss_fn(params, q, poses, noise=(torch.full((4, 1), 2.0), None, None))[0]
    edge = loss_fn(params, q, poses, noise=(torch.full((4, 1), 1.0 - 1e-5), None, None))[0]
    assert float(big) == float(edge)


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(warmup):
    ours = make_lr_schedule(1e-4, 0.5, 4, warmup)
    theirs = jax_make_lr_schedule(1e-4, 0.5, 4, warmup)
    for count in range(0, 40):
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-7, atol=0, err_msg=f"count {count}")
    if warmup:
        assert ours(0) == 0.0
    big = make_lr_schedule(1e-4, 0.9795, 39062, 0)
    for count in (0, 39061, 39062, 250_000, 10_000_000):
        np.testing.assert_allclose(big(count), float(jax_make_lr_schedule(1e-4, 0.9795, 39062)(count)), rtol=1e-7)


def _grad_sequence(shapes, n=7, seed=0):
    """n gradient sets: scales that put some elements over the clip (1.0)
    and make some steps' global norm fall under it."""
    rng = np.random.default_rng(seed)
    scales = [2.0, 0.5, 0.001, 3.0, 0.01, 1.0, 0.3][:n]
    return [[(s * rng.normal(size=shape)).astype(np.float32) for shape in shapes] for s in scales]


@pytest.mark.parametrize("warmup", [0, 2], ids=["no_warmup", "warmup"])
@pytest.mark.parametrize("clip", ["value", "norm"])
@pytest.mark.parametrize("name", ["adamw", "adam", "adadelta", "ranger"])
def test_optimizer_matches_optax(name, clip, warmup):
    shapes = [(6, 5), (5,), (5, 3), (3,)]
    rng = np.random.default_rng(1)
    init = [(0.05 * rng.normal(size=s)).astype(np.float32) for s in shapes]  # a subnet weight's scale
    grads = _grad_sequence(shapes)
    jopt = jax_make_optimizer(name, 1e-4, 0.5, 3, 1.0, warmup, clip)
    jparams = [jnp.asarray(p) for p in init]
    state = jopt.init(jparams)
    for g in grads:
        updates, state = jopt.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    params = [torch.from_numpy(p.copy()) for p in init]
    opt = make_optimizer(params, name, 1e-4, 0.5, 3, 1.0, warmup, clip)
    for g in grads:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    assert opt.count == len(grads)
    moved = max(np.abs(np.asarray(j) - p0).max() for j, p0 in zip(jparams, init))
    assert moved > 0
    for p, j, p0 in zip(params, jparams, init):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-6, rtol=0)
        ulps = 8 * np.finfo(np.float32).eps * np.abs(p0)  # the rounding of p itself
        assert (np.abs((p.numpy() - p0) - (np.asarray(j) - p0)) <= 1e-3 * moved + ulps).all()


def test_optimizer_state_round_trips_and_refuses_another_optimizer():
    shapes = [(4, 3), (3,)]
    grads = _grad_sequence(shapes)
    rng = np.random.default_rng(2)
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    for name in ("adamw", "ranger"):
        a = [torch.from_numpy(p.copy()) for p in init]
        opt_a = make_optimizer(a, name)
        for g in grads[:4]:
            for p, x in zip(a, g):
                p.grad = torch.from_numpy(x.copy())
            opt_a.step()
        b = [p.clone() for p in a]
        opt_b = make_optimizer(b, name)
        opt_b.load_state_dict(opt_a.state_dict())
        assert opt_b.count == 4 and opt_b.learning_rate == opt_a.learning_rate
        for g in grads[4:]:
            for params, opt in ((a, opt_a), (b, opt_b)):
                for p, x in zip(params, g):
                    p.grad = torch.from_numpy(x.copy())
                opt.step()
        for p, q in zip(a, b):
            torch.testing.assert_close(p, q, rtol=0, atol=0)
    with pytest.raises(ValueError, match="optimizer state is for"):
        make_optimizer([torch.zeros(3)], "adam").load_state_dict(opt_a.state_dict())
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer([torch.zeros(3)], "sgd")
    with pytest.raises(ValueError, match="gradient_clip_algorithm"):
        make_optimizer([torch.zeros(3)], "adam", gradient_clip_algorithm="bogus")
