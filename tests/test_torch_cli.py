"""``ikflow-torch solve / evaluate / benchmark / build-dataset`` on the CPU
(``--device cpu``) against the JAX package's ``ikflow-tpu`` on the same
arguments.

Draws differ between the frameworks, so the lines are compared with their
numbers masked, the JSON rows by their keys, and the grading on solutions
handed to both packages (within 1e-5). The default architecture is swapped
for the tiny flow in both packages, so each run takes seconds."""

import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ikflow_tpu.flow
import ikflow_tpu_torch.flow
from ikflow_tpu import registry as jax_registry
from ikflow_tpu.cli.main import main as jax_main
from ikflow_tpu.evaluation import solution_diversity as jax_solution_diversity
from ikflow_tpu.training import dataset as jax_dataset
from ikflow_tpu_torch import config, registry
from ikflow_tpu_torch.cli import evaluate_cmd
from ikflow_tpu_torch.cli.main import main
from ikflow_tpu_torch.training.dataset import dataset_directory, load_dataset
from ikflow_tpu_torch.utils import profiling
from test_torch_solver import _reachable, _solver_pair

POSE = ["--pose", "0.4", "0", "0.5", "1", "0", "0", "0"]
NUMBER = re.compile(r"-?\d+(\.\d*)?(e[-+]?\d+)?|\b(True|False)\b|\b(ok|FAIL)\b")


@pytest.fixture
def tiny_default(monkeypatch):
    """FlowHyperParams() in both packages' CLIs builds the tiny flow."""
    for module in (ikflow_tpu.flow, ikflow_tpu_torch.flow):
        tiny = module.tiny_model_params
        monkeypatch.setattr(module, "FlowHyperParams", tiny)


def _masked(out):
    """Lines with numbers, booleans and validity marks as '#'."""
    lines = (re.sub(r"\s+", " ", NUMBER.sub("#", line)).strip() for line in out.strip().splitlines())
    return [re.sub(r"\[ ?(.*?) ?\]", r"[\1]", line) for line in lines]


def _both(capsys, argv):
    """-> (port's stdout, JAX's stdout) of one argument list."""
    assert main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert jax_main(argv) == 0
    return port, capsys.readouterr().out


@pytest.mark.parametrize("form", [[], ["--exact"], ["--diverse", "--oversample", "3"]], ids=["detailed", "exact", "diverse"])
def test_solve_lines_match_jax(capsys, tiny_default, form):
    port, jax_out = _both(capsys, ["solve", "--robot_name", "panda"] + POSE + ["-n", "3", "--uninitialized"] + form)
    assert _masked(port) == _masked(jax_out)
    assert len(port.strip().splitlines()) == 3 + (1 if form and form[0] == "--diverse" else 0)
    if form == ["--exact"]:
        assert all(re.match(r"\[(ok|FAIL)\] \[", line) for line in port.splitlines())


def test_evaluate_lines_match_jax(capsys, tiny_default):
    """The same lines, but for the runtime's methodology, which names how the
    port timed it."""
    argv = ["evaluate", "--robot_name", "panda", "--uninitialized", "--testset_size", "8",
            "--n_samples_for_errors", "2", "--runtime_k", "1", "--n_runtime_samples", "4"]
    port, jax_out = _both(capsys, argv)
    strip = lambda lines: [re.sub(r"\(.*\)$", "(how)", x) if x.startswith("mean_runtime") else x for x in lines]  # noqa: E731
    assert strip(_masked(port)) == strip(_masked(jax_out))
    assert port.strip().splitlines()[-1].endswith((f"({evaluate_cmd.RUNTIME_DIFFERENCED})",
                                                   f"({evaluate_cmd.RUNTIME_PER_CALL})"))


def test_evaluate_refinement_and_unfiltered_testset(capsys, tiny_default):
    argv = ["evaluate", "--robot_name", "panda", "--uninitialized", "--testset_size", "4", "--n_samples_for_errors",
            "2", "--runtime_k", "1", "--n_runtime_samples", "2", "--do_refinement", "--self_colliding_dataset"]
    port, jax_out = _both(capsys, argv)
    assert _masked(port)[0] == _masked(jax_out)[0] == "exact-IK valid fraction: #"
    assert len(_masked(port)) == len(_masked(jax_out))


@pytest.mark.parametrize("sigmoid", [False, True])
def test_evaluate_grading_matches_jax(sigmoid):
    """``evaluate``'s accuracy block on the same solutions in both packages:
    the port's ``grade`` against the JAX CLI's expressions, within 1e-5."""
    js, ts = _solver_pair(sigmoid)
    n, m = 6, 4
    poses_t = _reachable(n, seed=3).repeat_interleave(m, dim=0)
    latent = np.random.default_rng(4).normal(size=(n * m, ts.network_width)).astype(np.float32)
    sols = ts.generate_ik_solutions(poses_t, latent=torch.from_numpy(0.75 * latent), clamp_to_joint_limits=False)
    got = evaluate_cmd.grade(ts, poses_t, sols, n, m)
    ev = js.evaluate(jnp.asarray(poses_t.numpy()), jnp.asarray(sols.numpy()))
    want = {
        "mean_l2_error_mm": 1000 * float(jnp.mean(ev.pos_errors)),
        "mean_angular_error_deg": float(jnp.rad2deg(jnp.mean(ev.rot_errors))),
        "pct_joint_limits_exceeded": 100 * float(jnp.mean(ev.joint_limits_exceeded.astype(jnp.float32))),
        "pct_self_colliding": 100 * float(jnp.mean(ev.self_colliding.astype(jnp.float32))),
        "mean_pairwise_dq_rad": float(jnp.mean(jax_solution_diversity(jnp.asarray(sols.numpy()), n, m))),
    }
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert want["pct_joint_limits_exceeded"] > 0 or sigmoid  # unclamped solutions do leave the limits


def _tiny_registry(monkeypatch):
    """Two registered models of the tiny architecture, without weights: one
    with softflow and the affine head, one with the sigmoid head."""
    base = dict(nb_nodes=3, coeff_fn_config=2, coeff_fn_internal_size=256, robot_name="panda")
    entries = {"tiny_softflow": dict(base, dim_latent_space=8),
               "tiny__sigmoid": dict(base, dim_latent_space=7, softflow_enabled=False, sigmoid_on_output=True)}
    for reg in (registry, jax_registry):
        monkeypatch.setattr(reg, "model_descriptions", lambda: entries)


def test_evaluate_all_writes_jax_header_and_columns(capsys, monkeypatch, tmp_path):
    _tiny_registry(monkeypatch)
    argv = ["evaluate", "--all", "--uninitialized", "--testset_size", "4", "--n_samples_for_errors", "2",
            "--runtime_k", "1", "--n_runtime_samples", "2"]
    port_file, jax_file = tmp_path / "port.md", tmp_path / "jax.md"
    assert main(argv + ["--performances_file", str(port_file), "--device", "cpu"]) == 0
    assert jax_main(argv + ["--performances_file", str(jax_file)]) == 0
    port, jax_out = port_file.read_text().splitlines(), jax_file.read_text().splitlines()
    assert port[0] == jax_out[0] == "# Model performances"
    assert _masked(port[2])[0] == _masked(jax_out[2])[0]  # "## <stamp> (4 poses x 2 sols, latent scale 0.75)"
    assert port[4:6] == jax_out[4:6]  # the header row and its rule
    rows = [line for line in port if line.startswith("| tiny")]
    assert [r.split(" | ")[0] for r in rows] == ["| tiny_softflow", "| tiny__sigmoid"]
    for row in rows:
        cells = [c.strip() for c in row.strip("|").split("|")]
        assert len(cells) == 9 and cells[1] == "panda" and cells[8] == "3"
        assert all(np.isfinite(float(c.split()[0])) for c in cells[2:8])
    assert any(line.startswith("†") for line in port) and any(line.startswith("\\*") for line in port)
    assert "wrote 2 rows" in capsys.readouterr().out


def test_build_dataset_output_loads_in_both_packages(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(config, "DATASET_DIR", str(tmp_path / "datasets"))
    monkeypatch.setattr(jax_dataset, "DATASET_DIR", str(tmp_path / "datasets"))
    out_dir = dataset_directory("panda", (config.DATASET_TAG_NON_SELF_COLLIDING,))
    assert out_dir == jax_dataset.dataset_directory("panda", (config.DATASET_TAG_NON_SELF_COLLIDING,))
    assert main(["build-dataset", "--robot_name", "panda", "--training_set_size", "256", "--test_set_size", "64",
                 "--output_dir", out_dir, "--device", "cpu"]) == 0
    assert re.fullmatch(r"built 256 train / 64 test samples for panda in \d+\.\ds -> .*\n", capsys.readouterr().out)
    ds, jds = load_dataset("panda"), jax_dataset.load_dataset("panda")
    for name in ("samples_tr", "endpoints_tr", "samples_te", "endpoints_te"):
        np.testing.assert_array_equal(np.asarray(getattr(ds, name)), np.asarray(getattr(jds, name)))
    robot = registry.get_robot("panda")
    q = torch.from_numpy(np.asarray(ds.samples_tr))
    assert not bool(robot.config_self_collides(q).any()) and not bool(robot.joint_limits_exceeded(q).any())
    assert os.path.exists(os.path.join(out_dir, "info.txt"))


@pytest.mark.parametrize("argv", [
    ["solve", "--robot_name", "panda", *POSE, "-n", "2", "--uninitialized"],
    ["evaluate", "--robot_name", "panda", "--uninitialized", "--testset_size", "2"],
    ["benchmark", "--robot_name", "panda", "--batch_sizes", "2"],
    ["build-dataset", "--robot_name", "panda", "--training_set_size", "16"],
], ids=lambda a: a[0])
def test_default_device_is_the_card(argv):
    """Without --device each subcommand asks for the card, and without one
    it raises: it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_runtime_escalation_stays_inside_its_budget(monkeypatch):
    """A refused x8 step whose x64 step is predicted past the budget falls
    back to per-call timing, labelled so; a cheap one escalates."""
    _, ts = _solver_pair()
    target = _reachable(1, seed=2)[0]
    scales, clock = [], {"now": 0.0}

    def refuse(build, label, **kw):
        scales.append(label)
        clock["now"] += 1.0  # each step "takes" 1 s
        raise profiling.DegenerateTimingError(label)

    monkeypatch.setattr(profiling, "measure_per_iter_s", refuse)
    monkeypatch.setattr(evaluate_cmd, "time", types.SimpleNamespace(perf_counter=lambda: clock["now"]))
    for budget, expected in ((4.0, ["runtime column (x8)"]),
                             (400.0, ["runtime column (x8)", "runtime column (x64)", "runtime column (x256)"])):
        scales.clear()
        monkeypatch.setattr(evaluate_cmd, "RUNTIME_ESCALATION_BUDGET_S", budget)
        ms, how = evaluate_cmd._runtime_ms(ts, target, 4, 0, True, 1)
        assert scales == expected and how == evaluate_cmd.RUNTIME_PER_CALL and ms >= 0
