"""The port's datasets, deploy export and export gate on the CPU, against the
JAX package where both have the function.

- Sampling and both dataset builders: in the margined joint limits, free of
  self-collision, poses equal to the port's FK of the rows (1e-6: the same
  function), the sizes asked for, and the same rows for the same seed.
- A dataset saved by either package loads in the other, equal.
- Deploy artifacts load across packages, leaf for leaf equal (fp32 and fp16
  storage), with flow inverses on the same latents within 1e-4 (fp32 sums
  in another order, as ``tests/test_torch_flow.py`` holds them).
- ``resolve_export_gate`` equals the JAX function case by case.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ikflow_tpu.config as jax_config
import ikflow_tpu.training.dataset as jax_dataset
from ikflow_tpu.training.checkpoints import export_deploy as jax_export_deploy, load_deploy as jax_load_deploy
from ikflow_tpu.training.checkpoints import resolve_export_gate as jax_resolve_export_gate
from ikflow_tpu_torch import config
from ikflow_tpu_torch.flow import FlowHyperParams
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.training import IkDataset, build_dataset, build_dataset_resident, load_dataset, save_dataset
from ikflow_tpu_torch.training.checkpoints import (
    DeployQualityError,
    export_deploy,
    flatten_params,
    load_deploy,
    read_deploy_header,
    registry_gate_mm,
    resolve_export_gate,
)
from ikflow_tpu_torch.training.dataset import DEFAULT_JOINT_LIMIT_EPS, dataset_directory, iterate_batches
from test_torch_training import flow_pair, jax_flat

EPS = DEFAULT_JOINT_LIMIT_EPS


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """Both packages' cache trees redirected to ``tmp_path``."""
    for module in (config, jax_config):
        monkeypatch.setattr(module, "CACHE_DIR", str(tmp_path))
        for name, sub in (("DATASET_DIR", "datasets"), ("MODELS_DIR", "models"),
                          ("TRAINING_LOGS_DIR", "training_logs")):
            monkeypatch.setattr(module, name, str(tmp_path / sub))
    monkeypatch.setattr(jax_dataset, "DATASET_DIR", str(tmp_path / "datasets"))
    return tmp_path


def _check_rows(q, poses, n, robot=get_robot("panda")):
    q, poses = torch.as_tensor(q), torch.as_tensor(poses)
    assert q.shape == (n, 7) and poses.shape == (n, 7) and q.dtype == torch.float32
    low, high = robot.limits_low() + EPS, robot.limits_high() - EPS
    assert bool(((q >= low - 1e-6) & (q <= high + 1e-6)).all())
    assert not bool(robot.config_self_collides(q).any())
    torch.testing.assert_close(robot.forward_kinematics(q), poses, atol=1e-6, rtol=0)


def test_sample_joint_angles_and_poses():
    robot = get_robot("panda")
    q, poses = robot.sample_joint_angles_and_poses(500, torch.Generator().manual_seed(0), EPS,
                                                   only_non_self_colliding=True)
    _check_rows(q, poses, 500)
    q2, _ = robot.sample_joint_angles_and_poses(500, torch.Generator().manual_seed(0), EPS,
                                                only_non_self_colliding=True)
    torch.testing.assert_close(q, q2, rtol=0, atol=0)
    # Unfiltered: the first draw itself, some of it colliding (about 20%).
    qu, _ = robot.sample_joint_angles_and_poses(2000, torch.Generator().manual_seed(1))
    torch.testing.assert_close(qu, robot.sample_joint_angles(2000, torch.Generator().manual_seed(1)))
    assert 0.1 < float(robot.config_self_collides(qu).float().mean()) < 0.3
    with pytest.raises(ValueError, match="collision-free"):
        robot.sample_joint_angles_and_poses(2000, torch.Generator().manual_seed(1), only_non_self_colliding=True,
                                            oversample_factor=1)


def test_build_dataset_host_filtered():
    ds = build_dataset(get_robot("panda"), training_set_size=3000, test_set_size=300, chunk_size=2048, device="cpu")
    assert all(isinstance(a, np.ndarray) for a in (ds.samples_tr, ds.endpoints_tr, ds.samples_te, ds.endpoints_te))
    assert ds.tags == (config.DATASET_TAG_NON_SELF_COLLIDING,) and ds.n_train == 3000
    _check_rows(ds.samples_tr, ds.endpoints_tr, 3000)
    _check_rows(ds.samples_te, ds.endpoints_te, 300)
    again = build_dataset(get_robot("panda"), training_set_size=3000, test_set_size=300, chunk_size=2048,
                          device="cpu")
    np.testing.assert_array_equal(ds.samples_tr, again.samples_tr)
    other = build_dataset(get_robot("panda"), training_set_size=3000, test_set_size=300, chunk_size=2048, seed=1,
                          device="cpu")
    assert not np.array_equal(ds.samples_tr, other.samples_tr)


def test_build_dataset_resident():
    robot = get_robot("panda")
    ds = build_dataset_resident(robot, training_set_size=3000, test_set_size=200, chunk_size=1024, device="cpu")
    assert isinstance(ds.samples_tr, torch.Tensor) and isinstance(ds.samples_te, np.ndarray)
    _check_rows(ds.samples_tr, ds.endpoints_tr, 3000)
    _check_rows(ds.samples_te, ds.endpoints_te, 200)
    again = build_dataset_resident(robot, training_set_size=3000, test_set_size=200, chunk_size=1024, device="cpu")
    torch.testing.assert_close(ds.samples_tr, again.samples_tr, rtol=0, atol=0)
    # Without redraws only the borrow step filters: a row still collides when
    # it and the two before it did, about 0.2 ** 3 of the rows, against about
    # 20% of the raw draw.
    raw = build_dataset_resident(robot, training_set_size=4096, test_set_size=8, chunk_size=4096, redraw_rounds=0,
                                 only_non_self_colliding=False, device="cpu")
    once = build_dataset_resident(robot, training_set_size=4096, test_set_size=8, chunk_size=4096, redraw_rounds=0,
                                  device="cpu")
    bad = robot.config_self_collides(raw.samples_tr)
    assert float(bad.float().mean()) > 0.1
    assert float(robot.config_self_collides(once.samples_tr).float().mean()) < 0.03
    # A colliding row took the row before it, or the one two before when
    # that one collides too.
    i = int(torch.nonzero(bad[2:] & ~bad[1:-1])[0]) + 2
    torch.testing.assert_close(once.samples_tr[i], raw.samples_tr[i - 1], rtol=0, atol=0)
    j = int(torch.nonzero(bad[2:] & bad[1:-1])[0]) + 2
    torch.testing.assert_close(once.samples_tr[j], raw.samples_tr[j - 2], rtol=0, atol=0)


def test_dataset_loads_across_packages(cache):
    robot = get_robot("panda")
    ds = build_dataset_resident(robot, training_set_size=600, test_set_size=64, chunk_size=256, device="cpu")
    directory = save_dataset(ds)
    assert directory == dataset_directory("panda", ds.tags) == jax_dataset.dataset_directory("panda", ds.tags)
    assert os.path.exists(os.path.join(directory, "info.txt"))
    theirs = jax_dataset.load_dataset("panda")
    np.testing.assert_array_equal(theirs.samples_tr, ds.samples_tr.numpy())
    np.testing.assert_array_equal(theirs.endpoints_te, ds.endpoints_te)

    jds = jax_dataset.IkDataset(theirs.samples_tr[:100], theirs.endpoints_tr[:100], theirs.samples_te[:10],
                                theirs.endpoints_te[:10], "panda", ("tiny",))
    jax_dataset.save_dataset(jds)
    ours = load_dataset("panda", ("tiny",))
    for name in ("samples_tr", "endpoints_tr", "samples_te", "endpoints_te"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(jds, name))
    assert ours.tags == ("tiny",)
    with pytest.raises(FileNotFoundError, match="no dataset"):
        load_dataset("panda", ("missing",))


@pytest.mark.parametrize("on_device", [False, True], ids=["numpy", "tensor"])
def test_iterate_batches_drops_the_last_partial_batch(on_device):
    rows = np.arange(10, dtype=np.float32)[:, None].repeat(7, axis=1)
    tr = torch.from_numpy(rows) if on_device else rows
    ds = IkDataset(tr, tr, rows[:2], rows[:2], "panda")
    it = iterate_batches(ds, 4, 0)
    passes = [[next(it) for _ in range(2)] for _ in range(3)]
    for batches in passes:
        ids = np.concatenate([np.asarray(q)[:, 0] for q, _ in batches])
        assert len(ids) == 8 and len(set(ids.tolist())) == 8  # 2 of the 10 rows left out each pass
    firsts = [np.asarray(batches[0][0])[:, 0].tolist() for batches in passes]
    assert firsts[0] != firsts[1] or firsts[1] != firsts[2]  # a new permutation per pass
    again = iterate_batches(ds, 4, 0)
    np.testing.assert_array_equal(np.asarray(next(again)[0]), np.asarray(passes[0][0][0]))


@pytest.mark.parametrize("dtype", [None, "float16"], ids=["fp32", "fp16"])
def test_deploy_artifacts_load_across_packages(tmp_path, dtype):
    jflow, jparams, flow, params = flow_pair(9, False, True)
    latents = np.random.default_rng(0).normal(size=(40, 9)).astype(np.float32)
    cond = np.random.default_rng(1).uniform(-1, 1, size=(40, 8)).astype(np.float32)

    def both_inverses(port_params, jax_params):
        ours = flow.inverse(port_params, torch.from_numpy(latents), torch.from_numpy(cond))[0].numpy()
        theirs = np.asarray(jflow.inverse(jax_params, jnp.asarray(latents), jnp.asarray(cond))[0])
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)

    # port -> JAX
    path = export_deploy(str(tmp_path / "port"), params, flow.hp, "panda", global_step=7, dtype=dtype)
    assert path.endswith("port.npz")
    jloaded, jheader = jax_load_deploy(path, jparams)
    ours, header = load_deploy(path, flow.param_shapes(), device="cpu")
    assert jheader == header and header["stored_dtype"] == (dtype or "native") and header["global_step"] == 7
    assert FlowHyperParams.from_dict(header["hyper_parameters"]) == flow.hp
    jflat = jax_flat(jloaded)
    for key, leaf in flatten_params(ours).items():
        np.testing.assert_array_equal(leaf, jflat[key])
    both_inverses(ours, jloaded)
    # JAX -> port
    jpath = jax_export_deploy(str(tmp_path / "jax.npz"), jparams, jflow.hp, "panda", global_step=9, dtype=dtype)
    from_jax, h2 = load_deploy(jpath, flow.param_shapes(), device="cpu")
    assert h2["global_step"] == 9 and h2["stored_dtype"] == (dtype or "native")
    expected = {k: np.asarray(v).astype(dtype or np.float32).astype(np.float32) for k, v in jax_flat(jparams).items()}
    for key, leaf in flatten_params(from_jax).items():
        np.testing.assert_array_equal(leaf, expected[key])
    both_inverses(from_jax, jax_load_deploy(jpath, jparams)[0])
    if dtype:
        assert os.path.getsize(path) < 0.65 * os.path.getsize(export_deploy(str(tmp_path / "p32"), params, flow.hp,
                                                                             "panda"))


def test_export_gate_refuses_and_records(tmp_path):
    _, _, flow, params = flow_pair(8, True, False)
    path = str(tmp_path / "m.npz")
    for quality in ({"val_l2_error_mm": 427.6}, {"val_l2_error_mm": float("inf")}, None):
        with pytest.raises(DeployQualityError):
            export_deploy(path, params, flow.hp, "panda", quality=quality, max_val_l2_mm=100.0)
    assert not os.path.exists(path)
    export_deploy(path, params, flow.hp, "panda", quality={"val_l2_error_mm": 7.9}, max_val_l2_mm=100.0)
    header = read_deploy_header(path)
    assert header["quality"]["val_l2_error_mm"] == pytest.approx(7.9) and header["quality_gate_mm"] == 100.0
    forced = str(tmp_path / "forced.npz")
    export_deploy(forced, params, flow.hp, "panda", quality={"val_l2_error_mm": 427.6}, max_val_l2_mm=None)
    assert read_deploy_header(forced)["quality"]["val_l2_error_mm"] == pytest.approx(427.6)
    assert read_deploy_header(str(tmp_path / "absent.npz")) is None


def test_export_warm_start_provenance(tmp_path):
    _, _, flow, params = flow_pair(8, True, False)
    path = export_deploy(str(tmp_path / "m.npz"), params, flow.hp, "panda", global_step=500_000,
                         warm_start={"from": "rizon4__full.npz", "prior_steps": 200_000, "total_steps": 700_000})
    header = read_deploy_header(path)
    assert header["global_step"] == 500_000
    assert header["warm_start"] == {"from": "rizon4__full.npz", "prior_steps": 200_000, "total_steps": 700_000}
    cold = export_deploy(str(tmp_path / "cold.npz"), params, flow.hp, "panda", global_step=100)
    assert "warm_start" not in read_deploy_header(cold)


def test_resolve_export_gate_matches_jax(tmp_path):
    jflow, jparams, flow, params = flow_pair(8, True, False)
    assert registry_gate_mm("panda__full_sigmoid.npz") == 13.0
    assert registry_gate_mm(str(tmp_path / "panda__full")) == 8.0
    assert registry_gate_mm("unregistered.npz") is None

    def incumbent(name, v, by_port):
        path = str(tmp_path / name)
        if by_port:
            export_deploy(path, params, flow.hp, "panda", quality={"val_l2_error_mm": v})
        else:
            jax_export_deploy(path, jparams, jflow.hp, "panda", quality={"val_l2_error_mm": v})
        return path

    cases = [
        (str(tmp_path / "nothing_here" / "panda__full_sigmoid.npz"), None),  # registry, no incumbent
        (str(tmp_path / "unregistered.npz"), None),  # backstop
        (str(tmp_path / "unregistered.npz"), 20.0),  # explicit
        (incumbent("panda__full_sigmoid.npz", 9.0, True), None),  # incumbent tightens below the registry
        (incumbent("fetch__large.npz", 15.0, False), None),  # incumbent relaxes above the registry
        (incumbent("panda__lite.npz", 11.9, True), 30.0),  # explicit, still bounded by the incumbent
        (incumbent("x.npz", float("inf"), False), None),  # a non-finite incumbent is ignored
    ]
    for path, policy in cases:
        ours, theirs = resolve_export_gate(path, policy), jax_resolve_export_gate(path, policy)
        assert ours[0] == pytest.approx(theirs[0]) and ours[1] == theirs[1], (path, policy, ours, theirs)
    assert resolve_export_gate(cases[3][0])[0] == pytest.approx(9.25)
    assert resolve_export_gate(cases[4][0])[0] == pytest.approx(15.0)
