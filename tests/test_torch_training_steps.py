"""The port's Trainer on the CPU: three update steps and validation against
the JAX package's, and the loop's behaviour (mirroring
``tests/test_training.py``).

Tolerances of the parity tests:
- steps: the same batches, and JAX's pad and softflow draws from the same
  keys, through 3 adamw steps at lr 1e-4. The ``tr/*`` loss and output
  metrics within 1e-5 relative, ``tr/grad_abs_ave`` and ``tr/grad_max``
  within 1e-4 relative, ``tr/grad_ave`` (a sum that cancels) within 1e-4 of
  ``tr/grad_abs_ave``; the parameters within 1e-6 absolute (measured
  8.9e-8; the metrics at most 1.3e-6 relative). The parameters get a margin
  because a gradient element near Adam's eps turns an fp32 rounding of the
  gradient into a larger change of the update;
- validation: the same latents (JAX's draw from its key); the errors within
  1e-4 relative, each percentage within one sample's share (a joint at its
  limit or a capsule pair at contact can flip under fp32 rounding).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu.training import IkDataset as JaxIkDataset, TrainConfig as JaxTrainConfig, Trainer as JaxTrainer
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.training import IkDataset, TrainConfig, Trainer, make_loss_fn
from ikflow_tpu_torch.training.checkpoints import flatten_params, latest_checkpoint_step, restore_checkpoint
from ikflow_tpu_torch.training.common import tree_leaves
from ikflow_tpu_torch.training.trainer import _trainable
from test_torch_training import batch, flow_pair, jax_flat, jax_noise

VAL_KEYS = [f"{tag}/{m}" for tag in ("val", "val_clamped") for m in (
    "l2_error_mm", "l2_error_mm_max", "angular_error_deg", "angular_error_deg_max",
    "pct_joint_limits_exceeded", "pct_self_colliding")]


def _dataset(n=512, n_te=64, seed=3):
    q, poses = batch(n + n_te, seed)
    return IkDataset(q[:n], poses[:n], q[n:], poses[n:], "panda")


def test_three_steps_match_jax():
    jflow, jparams, flow, params = flow_pair(9, False, True)
    cfg = JaxTrainConfig(batch_size=64)
    jtr = JaxTrainer(jflow, jax_get_robot("panda"), cfg)
    jstate = jtr.optimizer.init(jparams)
    tr = Trainer(flow, get_robot("panda"), TrainConfig(batch_size=64), device="cpu")
    p = _trainable(params)
    opt = tr.make_optimizer(p)
    for i in range(3):
        q, poses = batch(64, seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        jparams, jstate, jm = jtr._step_fn(jparams, jstate, key, jnp.asarray(q), jnp.asarray(poses))
        m = tr._step(p, opt, torch.from_numpy(q), torch.from_numpy(poses), noise=jax_noise(key, 64, flow))
        m = {k: float(v) for k, v in m.items()}
        jm = {k: float(v) for k, v in jm.items()}
        assert set(m) == set(jm) and len(m) == 9
        for k in ("tr/loss", "tr/loss_ml", "tr/output_max", "tr/output_abs_ave", "tr/output_std", "tr/output_ave"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=k)
        for k in ("tr/grad_abs_ave", "tr/grad_max"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
        assert abs(m["tr/grad_ave"] - jm["tr/grad_ave"]) <= 1e-4 * jm["tr/grad_abs_ave"]
    assert opt.count == 3
    jflat = jax_flat(jparams)
    for key_, leaf in flatten_params(p).items():
        np.testing.assert_allclose(leaf, jflat[key_], atol=1e-6, rtol=0, err_msg=key_)


@pytest.mark.parametrize("D,sigmoid,softflow", [(9, False, True), (7, True, False)], ids=["softflow", "sigmoid"])
def test_validate_matches_jax(D, sigmoid, softflow):
    jflow, jparams, flow, params = flow_pair(D, sigmoid, softflow)
    ds = _dataset(n=64, n_te=32)
    cfg = dict(val_set_size=8, samples_per_pose=10)
    key = jax.random.PRNGKey(4)
    jout = JaxTrainer(jflow, jax_get_robot("panda"), JaxTrainConfig(**cfg)).validate(
        jparams, JaxIkDataset(ds.samples_tr, ds.endpoints_tr, ds.samples_te, ds.endpoints_te, "panda"), key, 0)
    latents = torch.from_numpy(np.array(jax.random.normal(key, (80, D))))
    out = Trainer(flow, get_robot("panda"), TrainConfig(**cfg), device="cpu").validate(params, ds, latents=latents)
    assert sorted(out) == sorted(jout) == sorted(VAL_KEYS)
    for k in VAL_KEYS:
        if "pct" in k:
            assert abs(out[k] - jout[k]) <= 100.0 / 80 + 1e-4, k
        else:
            np.testing.assert_allclose(out[k], jout[k], rtol=1e-4, err_msg=k)
    assert out["val_clamped/pct_joint_limits_exceeded"] == 0.0
    if sigmoid:
        assert out["val/pct_joint_limits_exceeded"] == 0.0
    else:
        assert out["val/pct_joint_limits_exceeded"] > 0.0


def test_validate_follows_the_pose_count():
    _, _, flow, params = flow_pair(8, True, False)
    tr = Trainer(flow, get_robot("panda"), TrainConfig(val_set_size=16, samples_per_pose=4), device="cpu")
    g = torch.Generator().manual_seed(0)
    small, large = _dataset(n=32, n_te=8), _dataset(n=32, n_te=40)
    seen = []
    flow_inverse = flow.inverse
    flow.inverse = lambda p, z, c: (seen.append(z.shape[0]), flow_inverse(p, z, c))[1]
    tr.validate(params, small, g)
    tr.validate(params, large, g)
    assert seen == [8 * 4, 16 * 4]
    with pytest.raises(ValueError, match="generator or the latents"):
        tr.validate(params, small)


def _tiny():
    _, _, flow, params = flow_pair(8, True, False, width=64)
    return flow, params


def test_short_fit_loss_decreases_and_logs_the_taxonomy(tmp_path):
    flow, params = _tiny()
    robot = get_robot("panda")
    ds = _dataset(n=2048)
    cfg = TrainConfig(n_steps=60, batch_size=128, log_every=10, eval_every=0, learning_rate=2e-3)
    tr = Trainer(flow, robot, cfg, log_dir=str(tmp_path), device="cpu")
    loss_fn = make_loss_fn(flow, 7)
    q, poses = torch.from_numpy(ds.samples_tr[:256]), torch.from_numpy(ds.endpoints_tr[:256])
    loss0 = float(loss_fn(params, q, poses, generator=torch.Generator().manual_seed(9))[0])
    new_params, metrics = tr.fit(params, ds)
    loss1 = float(loss_fn(new_params, q, poses, generator=torch.Generator().manual_seed(9))[0])
    assert loss1 < loss0 and metrics["step"] == 60
    tr.close()
    lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) == 6
    rec = json.loads(lines[-1])
    for k in ("tr/loss", "tr/grad_max", "tr/grad_ave", "tr/grad_abs_ave", "tr/output_std", "tr/learning_rate",
              "tr/batches_p_sec", "step"):
        assert k in rec


def test_fit_on_device_loss_decreases_and_leaves_the_callers_params(tmp_path):
    flow, params = _tiny()
    before = [t.clone() for t in tree_leaves(params)]
    ds = _dataset(n=2048)
    seen = []
    cfg = TrainConfig(n_steps=60, batch_size=128, log_every=20, eval_every=60, learning_rate=2e-3,
                      val_set_size=4, samples_per_pose=8)
    tr = Trainer(flow, get_robot("panda"), cfg, metric_hook=lambda s, m: seen.append((s, m)), device="cpu")
    new_params, metrics = tr.fit_on_device(params, ds, steps_per_call=20)
    assert metrics["step"] == 60
    windows = [m for _, m in seen if "tr/loss_window_mean" in m]
    assert [s for s, m in seen if "tr/loss_window_mean" in m] == [20, 40, 60]
    assert windows[-1]["tr/loss_window_mean"] < windows[0]["tr/loss_window_mean"]
    assert any("val/l2_error_mm" in m for _, m in seen)  # eval at step 60
    for a, b in zip(before, tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not all(torch.equal(a, b) for a, b in zip(before, tree_leaves(new_params)))
    assert not any(t.requires_grad for t in tree_leaves(new_params))
    # fit leaves them too.
    tr.fit(params, ds)
    for a, b in zip(before, tree_leaves(params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_time_budget_reports_the_step_reached():
    flow, params = _tiny()
    cfg = TrainConfig(n_steps=10_000, batch_size=32, log_every=5, eval_every=0, checkpoint_every=0)
    _, metrics = Trainer(flow, get_robot("panda"), cfg, device="cpu").fit_on_device(
        params, _dataset(n=256), steps_per_call=5, time_budget_s=0.0)
    assert metrics["step"] == 5


def test_logged_lr_follows_the_optimizer_count():
    """A resume whose optimizer state was reset restarts the schedule at 0:
    the logged LR is the schedule at the optimizer's count, not at the
    global step."""
    flow, params = _tiny()
    ds = _dataset(n=256)
    cfg = TrainConfig(n_steps=4, batch_size=64, log_every=1, eval_every=0, checkpoint_every=0, step_lr_every=1,
                      gamma=0.5, learning_rate=1e-3)
    tr = Trainer(flow, get_robot("panda"), cfg, device="cpu")
    _, m = tr.fit(params, ds)
    assert m["step"] == 4 and m["tr/learning_rate"] == pytest.approx(1e-3 * 0.5 ** 4, rel=1e-6)
    _, m2 = tr.fit(params, ds, start_step=2, opt_state=None)
    assert m2["step"] == 4 and m2["tr/learning_rate"] == pytest.approx(1e-3 * 0.5 ** 2, rel=1e-6)
    _, m3 = tr.fit_on_device(params, ds, steps_per_call=2, start_step=2)
    assert m3["step"] == 4 and m3["tr/learning_rate"] == pytest.approx(1e-3 * 0.5 ** 2, rel=1e-6)


def test_checkpoints_round_trip_keep_three_and_resume(tmp_path):
    flow, params = _tiny()
    ds = _dataset(n=512)
    ckpt = str(tmp_path / "ckpt")
    cfg = TrainConfig(n_steps=10, batch_size=32, log_every=0, eval_every=0, checkpoint_every=2)
    tr = Trainer(flow, get_robot("panda"), cfg, device="cpu")
    trained, _ = tr.fit(params, ds, checkpoint_dir=ckpt)
    assert sorted(os.listdir(ckpt)) == ["10", "6", "8"] and latest_checkpoint_step(ckpt) == 10
    restored, step = restore_checkpoint(ckpt)
    assert step == 10 and restored["opt_state"]["count"] == 10 and restored["opt_state"]["name"] == "adamw"
    for a, b in zip(tree_leaves(trained), tree_leaves(restored["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert restore_checkpoint(ckpt, step=6)[1] == 6
    assert latest_checkpoint_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))

    # A resume continues the optimizer from its state and draws a fresh
    # stream: steps 10-11 from step 10's checkpoint differ from steps 0-1 of
    # a run started on the same parameters, and repeat themselves.
    cfg2 = TrainConfig(n_steps=12, batch_size=32, log_every=0, eval_every=0, checkpoint_every=0)
    tr2 = Trainer(flow, get_robot("panda"), cfg2, device="cpu")
    resumed_a, _ = tr2.fit(restored["params"], ds, start_step=10, opt_state=restored["opt_state"])
    resumed_b, _ = tr2.fit(restored["params"], ds, start_step=10, opt_state=restored["opt_state"])
    cfg3 = TrainConfig(n_steps=2, batch_size=32, log_every=0, eval_every=0, checkpoint_every=0)
    fresh, _ = Trainer(flow, get_robot("panda"), cfg3, device="cpu").fit(
        restored["params"], ds, opt_state=restored["opt_state"])
    for a, b in zip(tree_leaves(resumed_a), tree_leaves(resumed_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed_a), tree_leaves(fresh)))
