"""The analysis studies (``ikflow_tpu_torch/analysis/``) on the CPU against
the JAX package's scripts under ``analysis/``.

- Lines: each study's ``main`` with ``--device cpu`` and the JAX script's
  ``main`` on the same flags, both packages' default architecture swapped
  for the tiny flow; the lines are compared with their numbers masked, and
  the JSON rows and the pickle by their keys, through the rename map
  (``analysis.RENAMES``: xla -> plain, pallas -> kernel, tpu_lm -> gpu_lm).
- Numbers: the same poses and latents (numpy, seeded) through both
  packages, the port's weights from ``params_from_jax``: the latent
  statistics and the post-training accuracy block within 1e-5 (metres and
  radians; percentages exactly), and ``inverse_plain`` equal to ``inverse``
  on the CPU, where both run the plain subnets.
- On the CPU the kernel's row is an error row, and every study raises
  without a card unless it is given ``--device cpu``.
"""

import importlib
import json
import os
import pickle
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ikflow_tpu.flow
import ikflow_tpu_torch.flow
from ikflow_tpu.lm import config_pose_errors as jax_config_pose_errors
from ikflow_tpu.training.checkpoints import export_deploy as jax_export_deploy
from ikflow_tpu_torch.analysis import (
    RENAMES,
    inference_optimization,
    lm_convergence_analysis,
    multihost_smoke,
    post_training_eval,
    renamed,
    robot_visualizations,
    solution_refinement_runtime,
)
from ikflow_tpu_torch.flow import build_flow, tiny_model_params
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.utils import profiling
from test_torch_solver import _reachable, _solver_pair

ANALYSIS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "analysis")
NUMBER = re.compile(r"-?\d+(\.\d*)?(e[-+]?\d+)?")


@pytest.fixture
def tiny_default(monkeypatch):
    """FlowHyperParams() in both packages builds the tiny flow."""
    for module in (ikflow_tpu.flow, ikflow_tpu_torch.flow):
        monkeypatch.setattr(module, "FlowHyperParams", module.tiny_model_params)


def _masked(out):
    """Lines with their numbers as '#', the JAX names renamed."""
    lines = []
    for line in out.strip().splitlines():
        for jax_name, port_name in RENAMES.items():
            line = re.sub(rf"\b{jax_name}\b", port_name, line)
        lines.append(NUMBER.sub("#", line).strip())
    return lines


def _both(capsys, monkeypatch, port_module, script, argv):
    """-> (port's stdout, JAX's stdout) of one argument list."""
    assert port_module.main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    monkeypatch.syspath_prepend(ANALYSIS_DIR)
    jax_main = importlib.import_module(script).main
    monkeypatch.setattr(sys, "argv", [script] + argv)
    assert jax_main() == 0
    return port, capsys.readouterr().out


def _virtual_clock(monkeypatch):
    """The port's differenced timing on a virtual clock (1 ms per chained
    pass, each pass still run), so a busy CPU's noise cannot refuse it."""
    measure = profiling.measure_per_iter_s

    def virtual(build, label, **kw):
        clock = [0.0]

        def timed_build(iters):
            fn = build(iters)

            def run(i):
                fn(i)
                clock[0] += 1e-3 * iters

            return run

        return measure(timed_build, label, time_fn=lambda: clock[0], **kw)

    monkeypatch.setattr(profiling, "measure_per_iter_s", virtual)


# ---------------------------------------------------------------- lines

def test_lm_convergence_lines_match_jax(capsys, monkeypatch, tiny_default):
    port, jax_out = _both(capsys, monkeypatch, lm_convergence_analysis, "lm_convergence_analysis",
                          ["--n", "16", "--repeat_counts", "1", "--step_budgets", "2", "3"])
    assert _masked(port) == _masked(jax_out)
    assert len(port.strip().splitlines()) == 4
    for line in port.strip().splitlines()[2:]:
        valid, seconds = (float(x) for x in line.strip("| ").split(" | ")[2:])
        assert 0.0 <= valid <= 100.0 and seconds > 0


def test_inference_optimization_rows_match_jax(capsys, monkeypatch, tiny_default):
    """The same rows by key and backend (the JAX names renamed); on the CPU
    the kernel's row is an error row in both packages."""
    _virtual_clock(monkeypatch)
    port, jax_out = _both(capsys, monkeypatch, inference_optimization, "inference_optimization",
                          ["--batch_sizes", "32", "--iters", "2"])
    port_rows = [json.loads(line) for line in port.strip().splitlines()]
    jax_rows = [json.loads(line) for line in jax_out.strip().splitlines()]
    assert [(r["backend"], sorted(r)) for r in port_rows] == [(renamed(r["backend"]), sorted(r)) for r in jax_rows]
    plain, kernel = port_rows
    assert plain["bf16"] is False and plain["ms_per_pass"] > 0 and plain["samples_per_s"] > 0
    assert kernel == {"backend": "kernel", "batch": 32, "error": inference_optimization.KERNEL_CPU_ERROR}


def test_inference_optimization_aliases_and_bf16(capsys, monkeypatch, tiny_default):
    """The JAX backend names are aliases; --bf16 runs the plain bf16 flow."""
    _virtual_clock(monkeypatch)
    argv = ["--batch_sizes", "16", "--iters", "2", "--bf16", "--backends", "pallas", "xla", "--device", "cpu"]
    assert inference_optimization.main(argv) == 0
    kernel, plain = (json.loads(line) for line in capsys.readouterr().out.strip().splitlines())
    assert kernel["backend"] == "kernel" and "error" in kernel
    assert plain["backend"] == "plain" and plain["bf16"] is True and plain["ms_per_pass"] > 0
    with pytest.raises(SystemExit):
        inference_optimization.main(["--backends", "triton", "--device", "cpu"])


def _keys(tree):
    """A pickle's structure: nested dict keys, arrays as their shapes."""
    if isinstance(tree, dict):
        return {renamed(k): _keys(v) for k, v in tree.items()}
    return np.shape(tree) if isinstance(tree, np.ndarray) else type(tree).__name__


def test_refinement_runtime_lines_and_pickle_match_jax(capsys, monkeypatch, tiny_default, tmp_path):
    pkl = str(tmp_path / "runtime.pkl")
    argv = ["--batch_sizes", "8", "--k", "1", "--out_pickle", pkl]
    assert solution_refinement_runtime.main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    with open(pkl, "rb") as f:
        port_data = pickle.load(f)
    monkeypatch.syspath_prepend(ANALYSIS_DIR)
    monkeypatch.setattr(sys, "argv", ["solution_refinement_runtime"] + argv)
    assert importlib.import_module("solution_refinement_runtime").main() == 0
    jax_out = capsys.readouterr().out
    with open(pkl, "rb") as f:
        jax_data = pickle.load(f)
    assert _masked(port) == _masked(jax_out)
    assert "gpu_lm ms (success %)" in port and "tpu_lm" not in port
    assert _keys(port_data) == _keys(jax_data)
    for s in solution_refinement_runtime.solver_names(port_data):
        assert np.all(port_data[s]["runtimes"] > 0) and np.all((0 <= port_data[s]["pct_success"]) &
                                                               (port_data[s]["pct_success"] <= 1))


def test_robot_visualizations_lines_match_jax(capsys, monkeypatch, tiny_default, tmp_path):
    argv = ["--n_solutions", "3", "--n_poses", "4", "--n_sols_per_pose", "2", "--out_dir", str(tmp_path)]
    port, jax_out = _both(capsys, monkeypatch, robot_visualizations, "robot_visualizations", argv)
    assert _masked(port) == _masked(jax_out)
    assert os.path.getsize(tmp_path / "panda_solutions.png") > 0


@pytest.fixture
def tiny_artifact(tmp_path):
    """A deploy artifact of the tiny flow, written by the JAX package."""
    import jax

    from ikflow_tpu.solver import IKFlowSolver as JaxSolver
    from ikflow_tpu.robots import get_robot as jax_get_robot

    hp = ikflow_tpu.flow.tiny_model_params()
    js = JaxSolver(hp, jax_get_robot("panda"), seed=3)
    return jax_export_deploy(str(tmp_path / "tiny.npz"), jax.tree_util.tree_map(np.asarray, js.params), hp, "panda",
                             global_step=7)


def test_post_training_eval_lines_match_jax(capsys, monkeypatch, tiny_artifact):
    """The same lines (the numerics protocol runs only on an accelerator,
    so in neither package here). The JAX script's exact solves are replaced
    by all-invalid results of their shapes: its lines keep their form, and
    the suite is spared its 15 tier compiles (about 30 s); the port's
    solves run, and the accuracy block's numbers are held to JAX below."""
    from ikflow_tpu.solver import IKFlowSolver as JaxSolver

    def jax_exact_shapes(self, target_poses, **kw):
        n = target_poses.shape[0]
        return jnp.zeros((n, self.robot.ndof)), jnp.zeros((n,), bool)

    monkeypatch.setattr(JaxSolver, "generate_exact_ik_solutions", jax_exact_shapes)
    port, jax_out = _both(capsys, monkeypatch, post_training_eval, "post_training_eval",
                          ["--weights", tiny_artifact, "--n_accuracy", "4", "--n_exact", "16"])
    assert _masked(port) == _masked(jax_out)
    rows = [json.loads(line) for line in port.strip().splitlines()[1:]]
    assert [r["protocol"] for r in rows] == ["accuracy_500x50_scale0.75", "exact_steps2_full", "exact_steps3_full",
                                             "exact_steps5_full", "exact_steps3_capped", "exact_steps5_capped"]
    jax_rows = [json.loads(line) for line in jax_out.strip().splitlines()[1:]]
    assert [sorted(r) for r in rows] == [sorted(r) for r in jax_rows]
    for r in rows[1:]:
        assert 0.0 <= r["valid_fraction"] <= 1.0 and r["seconds"] > 0
    assert post_training_eval.main(["--weights", tiny_artifact, "--n_accuracy", "2", "--n_exact", "8", "--pallas",
                                    "--device", "cpu"]) == 0


# ---------------------------------------------------------------- numbers

def test_latent_distribution_stats_match_jax():
    """Every (distribution, scale) cell on the same targets and latents:
    mean position error within 1e-5 m and rotation error within 1e-5 rad of
    the JAX package's solutions and pose errors."""
    js, ts = _solver_pair()
    n_poses, n_sols = 4, 3
    targets = _reachable(n_poses, seed=5)
    rng = np.random.default_rng(6)
    latents = []
    for dist, scale in robot_visualizations.CELLS:
        shape = (n_poses * n_sols, ts.network_width)
        draw = rng.normal(size=shape) if dist == "gaussian" else 2.0 * rng.uniform(size=shape) - 1.0
        latents.append((scale * draw).astype(np.float32))
    rows = robot_visualizations.latent_distribution_stats(ts, n_poses, n_sols, targets=targets,
                                                          latents=[torch.from_numpy(z) for z in latents])
    tiled = jnp.repeat(jnp.asarray(targets.numpy()), n_sols, axis=0)
    for (dist, scale, mm, deg), z, cell in zip(rows, latents, robot_visualizations.CELLS):
        assert (dist, scale) == cell
        sols = js.generate_ik_solutions(tiled, latent=jnp.asarray(z), allow_uninitialized=True)
        pos, rot = jax_config_pose_errors(js.robot, sols, tiled)
        np.testing.assert_allclose(mm / 1000.0, float(jnp.mean(pos)), atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.radians(deg), float(jnp.mean(rot)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("sigmoid", [False, True])
def test_post_training_accuracy_matches_jax(sigmoid):
    """The accuracy block on the same test poses and latents: errors within
    1e-5 (m, rad) of the JAX package's ``evaluate`` of its own solutions,
    the shares of joint-limit and self-colliding solutions equal."""
    js, ts = _solver_pair(sigmoid)
    n, m = 5, 4
    testset = _reachable(n, seed=8)
    latent = (0.75 * np.random.default_rng(9).normal(size=(n * m, ts.network_width))).astype(np.float32)
    got = post_training_eval.accuracy(ts, testset, torch.from_numpy(latent), m)
    poses_t = jnp.repeat(jnp.asarray(testset.numpy()), m, axis=0)
    ev = js.evaluate(poses_t, js.generate_ik_solutions(poses_t, latent=jnp.asarray(latent), allow_uninitialized=True))
    assert got["protocol"] == "accuracy_500x50_scale0.75"
    np.testing.assert_allclose(got["mean_l2_error_mm"] / 1000.0, float(jnp.mean(ev.pos_errors)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.radians(got["mean_angular_error_deg"]), float(jnp.mean(ev.rot_errors)), atol=1e-5,
                               rtol=0)
    assert got["pct_joint_limits_exceeded"] == pytest.approx(100 * float(jnp.mean(ev.joint_limits_exceeded)))
    assert got["pct_self_colliding"] == pytest.approx(100 * float(jnp.mean(ev.self_colliding)))


@pytest.mark.parametrize("bf16", [False, True])
def test_inverse_plain_equals_inverse_on_cpu(bf16):
    """On the CPU both run the plain subnets: equal bit for bit, from the
    unpacked parameters and from ``kernel_params`` (bf16: packed weights)."""
    hp = tiny_model_params()
    hp.dim_latent_space, hp.sigmoid_on_output, hp.softflow_enabled = 7, True, False
    hp.bf16_hidden = bf16
    flow = build_flow(hp, get_robot("panda"))
    params = flow.init(torch.Generator().manual_seed(0))
    z = torch.randn((33, 7), generator=torch.Generator().manual_seed(1))
    cond = _reachable(33, seed=2)
    q_plain, ld_plain = flow.inverse_plain(params, z, cond)
    q_kernel, ld_kernel = flow.inverse(flow.kernel_params(params), z, cond)
    assert torch.equal(q_plain, q_kernel) and torch.equal(ld_plain, ld_kernel)
    q_fwd, _ = flow.forward(params, q_plain, cond)
    np.testing.assert_allclose(q_fwd.numpy(), z.numpy(), atol=1e-4)  # the inverse of the forward map


def test_solver_never_runs_inverse_plain(monkeypatch):
    """``inverse_plain`` is the studies' reference, never the solver's path."""
    def refuse(*a, **k):
        raise AssertionError("the solver ran inverse_plain")

    monkeypatch.setattr(ikflow_tpu_torch.flow.GlowFlow, "inverse_plain", refuse)
    _, ts = _solver_pair()
    poses = _reachable(6, seed=4)
    ts.generate_ik_solutions(poses, return_detailed=True)
    ts.generate_exact_ik_solutions(poses, repeat_counts=(1, 2), n_opt_steps_max=2)
    ts.generate_diverse_ik_solutions(poses[0], 3)


# ---------------------------------------------------------------- the device rule

@pytest.mark.parametrize("module,argv", [
    (lm_convergence_analysis, ["--n", "4"]),
    (inference_optimization, ["--batch_sizes", "8"]),
    (solution_refinement_runtime, ["--batch_sizes", "4"]),
    (post_training_eval, ["--weights", "unused.npz"]),
    (robot_visualizations, ["--n_poses", "2"]),
    (multihost_smoke, []),
], ids=lambda x: x.__name__.rsplit(".", 1)[-1] if hasattr(x, "__name__") else None)
def test_studies_raise_without_a_card(module, argv, monkeypatch, tiny_default, tmp_path):
    """``--device`` defaults to cuda, which raises here."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        module.main(argv)
    assert os.listdir(tmp_path) == []  # nothing written before the refusal
