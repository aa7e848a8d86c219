"""``ikflow-torch train`` on the CPU (``--device cpu``), against a temporary
cache tree: the smoke run, a warm start from a deploy artifact with its
refusals, a resume with the resident dataset, and the export gate."""

import json
import os

import pytest
import torch

from ikflow_tpu_torch import config
from ikflow_tpu_torch.cli.main import main
from ikflow_tpu_torch.training.checkpoints import export_deploy, latest_checkpoint_step, read_deploy_header
from test_torch_training import flow_pair

TINY = ["--robot_name", "panda", "--nb_nodes", "3", "--dim_latent_space", "8", "--coeff_fn_config", "2",
        "--coeff_fn_internal_size", "256", "--device", "cpu"]


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(config, "CACHE_DIR", str(tmp_path / "cache"))
    for name, sub in (("DATASET_DIR", "datasets"), ("MODELS_DIR", "models"), ("TRAINING_LOGS_DIR", "logs")):
        monkeypatch.setattr(config, name, str(tmp_path / "cache" / sub))
    return tmp_path


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["tr/loss"] for r in map(json.loads, f) if "tr/loss" in r]


def test_train_smoke(cache, capsys):
    run_dir = str(cache / "smoke")
    assert main(["train", "--robot_name", "panda", "--smoke", "--device", "cpu", "--run_dir", run_dir]) == 0
    out = capsys.readouterr().out
    assert "trained 200 steps (0 -> 200)" in out
    losses = _losses(run_dir)
    assert len(losses) == 10 and losses[-1] < losses[0]
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["hyper_parameters"]["nb_nodes"] == 3 and cfg["dataset_sizes"] == {"train": 8192, "test": 512}
    assert latest_checkpoint_step(os.path.join(run_dir, "checkpoints")) == 200


def test_train_warm_start_resume_and_export_gate(cache, capsys):
    _, _, flow, params = flow_pair(8, False, True, width=256)
    deploy = export_deploy(str(cache / "warm.npz"), params, flow.hp, "panda", global_step=123,
                           quality={"val_l2_error_mm": 5.0})
    run_dir = str(cache / "run")
    common = TINY + ["--dataset_size", "1024", "--batch_size", "64", "--eval_every", "1000", "--log_every", "2",
                     "--checkpoint_every", "0", "--val_set_size", "8", "--run_dir", run_dir,
                     "--dataset_tags", "tiny-warmstart-fixture"]
    exported = str(cache / "out" / "tiny.npz")
    assert main(["train", "--init_npz", deploy, "--n_steps", "4", "--export", exported, "--export_force"]
                + common) == 0
    out = capsys.readouterr().out
    assert "warm-started from deploy artifact" in out and "previously trained to step 123" in out
    assert "tag0=tiny-warmstart-fixture" in out  # the generated dataset is saved under the requested tags
    header = read_deploy_header(exported)
    assert header["global_step"] == 4 and header["quality_gate_mm"] is None
    assert header["warm_start"] == {"from": "warm.npz", "prior_steps": 123, "total_steps": 127}
    assert header["quality"]["val_l2_error_mm"] > 100.0  # an untrained flow: shipped only because forced

    # Resume from the run's checkpoint, on the resident path: the optimizer
    # state comes back, the provenance is recovered from config.json, and the
    # gate (the 100 mm backstop) refuses the untrained flow.
    refused = str(cache / "out" / "refused.npz")
    rc = main(["train", "--resume", os.path.join(run_dir, "checkpoints"), "--n_steps", "6", "--on_device_data",
               "--steps_per_call", "2", "--export", refused] + common)
    out = capsys.readouterr().out
    assert rc == 1 and "EXPORT REFUSED" in out and not os.path.exists(refused)
    assert "resumed from" in out and "at step 4 (opt_state restored)" in out and "trained 2 steps (4 -> 6)" in out
    with open(os.path.join(run_dir, "config.json")) as f:
        assert json.load(f)["warm_start"] == {"from": "warm.npz", "prior_steps": 123}
    assert latest_checkpoint_step(os.path.join(run_dir, "checkpoints")) == 6


def test_train_refuses_a_mismatched_artifact(cache):
    for robot, sigmoid, match in (("fetch", False, "deploy artifact is for robot"),
                                  ("panda", True, "hyperparameter mismatch")):
        _, _, flow, params = flow_pair(8, sigmoid, True, width=256)
        path = export_deploy(str(cache / f"{robot}_{sigmoid}.npz"), params, flow.hp, robot, global_step=1)
        with pytest.raises(ValueError, match=match):
            main(["train", "--init_npz", path, "--dataset_size", "256", "--n_steps", "2", "--batch_size", "64",
                  "--run_dir", str(cache / "run2"), "--dataset_tags", "tiny-warmstart-fixture"] + TINY)


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--robot_name", "panda", "--smoke"])


def test_train_data_parallel(cache, capsys):
    """``--data_parallel`` with ``--device cpu``: a mesh of the CPU, JAX's
    line, and a run that trains; without a card and without ``--device`` it
    raises, as every subcommand does."""
    run_dir = str(cache / "dp")
    argv = ["train", "--data_parallel", "--dataset_size", "512", "--n_steps", "4", "--batch_size", "64",
            "--log_every", "1", "--eval_every", "0", "--checkpoint_every", "0", "--val_set_size", "8",
            "--run_dir", run_dir, "--dataset_tags", "tiny-dp-fixture"] + TINY
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "data-parallel over 1 devices" in out and "trained 4 steps (0 -> 4)" in out
    assert len(_losses(run_dir)) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["train", "--robot_name", "panda", "--smoke", "--data_parallel"])
