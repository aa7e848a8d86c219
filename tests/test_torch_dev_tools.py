"""The port's artifact tools (``ikflow_tpu_torch/scripts_dev/``) against the
JAX package's scripts of the same names on the CPU, on tiny artifacts.

Each JAX script is loaded from ``scripts_dev/`` as
``tests/test_warmstart_tools.py`` loads it, and both run on the same files;
the JAX parameters reach the port through ``params_from_jax``. Bars:

- ``convert_softflow_init``: the converted arrays and headers equal exactly
  (both drop the same rows of the same numbers and store them as float16);
- ``grow_flow_init``: the source blocks and the zeroed last layers of the
  new blocks equal exactly; each tool's grown flow gives the source's NLL
  on the same inputs within 1e-4, tighter than the tools' own 1e-3 bar and
  loose enough for float32 sums in another order (the source is stored as
  float16, so the copied blocks are its values exactly);
- ``export_from_checkpoint``: the artifact's arrays and header equal those
  of the JAX package's ``export_deploy`` on the same parameters, quality and
  gate; a missing validation record returns 1; flags that build another
  architecture raise;
- ``stamp_warm_start``: the header and arrays equal the JAX tool's, apart
  from the ``stamp`` note, which names the tool that wrote it; a second
  stamp leaves the file alone;
- ``stamp_quality_headers``: above its gate it refuses and leaves the file
  alone; below, it writes the JAX tool's header keys.
"""

import functools
import importlib.util
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from ikflow_tpu.flow import build_flow as jax_build_flow, tiny_model_params as jax_tiny
from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu.training.checkpoints import export_deploy as jax_export_deploy
from ikflow_tpu_torch.flow import FlowHyperParams, build_flow
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.scripts_dev import (
    convert_softflow_init,
    export_from_checkpoint,
    grow_flow_init,
    stamp_quality_headers,
    stamp_warm_start,
)
from ikflow_tpu_torch.training.checkpoints import load_deploy, params_from_jax, read_artifact, save_checkpoint

_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts_dev")
NLL_ATOL = 1e-4


def _load(name):
    if _SCRIPTS not in sys.path:  # as when a script runs from its directory: it imports _pathfix
        sys.path.insert(0, _SCRIPTS)
    spec = importlib.util.spec_from_file_location(name, os.path.join(_SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _tiny_artifact(path, softflow, sigmoid, seed, dtype=None, global_step=7):
    """A tiny JAX flow exported to ``path``: -> its hyperparameters."""
    hp = jax_tiny()
    hp.dim_latent_space, hp.softflow_enabled, hp.sigmoid_on_output = 8, softflow, sigmoid
    flow = jax_build_flow(hp, jax_get_robot("panda"))
    jax_export_deploy(str(path), flow.init(jax.random.PRNGKey(seed)), hp, "panda", global_step=global_step,
                      dtype=dtype)
    return hp


def _assert_same_artifact(a, b, skip_header=()):
    (ha, xa), (hb, xb) = read_artifact(str(a)), read_artifact(str(b))
    assert {k: v for k, v in ha.items() if k not in skip_header} == {
        k: v for k, v in hb.items() if k not in skip_header}
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert xa[k].dtype == xb[k].dtype and np.array_equal(xa[k], xb[k]), k


def test_convert_softflow_init_equals_jax(tmp_path, capsys):
    src = tmp_path / "tiny_softflow.npz"
    _tiny_artifact(src, softflow=True, sigmoid=False, seed=5, global_step=9)
    _load("convert_softflow_init").main(str(src), str(tmp_path / "jax.npz"))
    assert convert_softflow_init.main([str(src), str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("block equivalence verified: max |dq| = ") and out[-2].endswith(" over 64 probes")
    assert out[-1].startswith("wrote warm-start init -> ") and "dropped" in out[-1]
    _assert_same_artifact(tmp_path / "port.npz", tmp_path / "jax.npz")
    header, arrays = read_artifact(str(tmp_path / "port.npz"))
    assert header["hyper_parameters"]["sigmoid_on_output"] and not header["hyper_parameters"]["softflow_enabled"]
    assert header["stored_dtype"] == "float16" and arrays["0/s1/0/w"].dtype == np.float16


def test_convert_softflow_init_refuses_a_sigmoid_source(tmp_path):
    src = tmp_path / "tiny_sigmoid.npz"
    _tiny_artifact(src, softflow=False, sigmoid=True, seed=5)
    with pytest.raises(AssertionError, match="softflow-conditioned affine-head"):
        convert_softflow_init.main([str(src), str(tmp_path / "port.npz"), "--device", "cpu"])


def _nll(path, x, cond):
    header, _ = read_artifact(str(path))
    hp = FlowHyperParams.from_dict(header["hyper_parameters"])
    flow = build_flow(hp, get_robot("panda"))
    params, _ = load_deploy(str(path), flow.param_shapes(), "cpu")
    with torch.no_grad():
        z, logdet = flow.forward(params, x, cond)
    return (0.5 * torch.sum(z * z, dim=1) - logdet).numpy()


def test_grow_flow_init_equals_jax(tmp_path, capsys):
    src = tmp_path / "tiny_sigmoid.npz"
    hp = _tiny_artifact(src, softflow=False, sigmoid=True, seed=3, dtype="float16")
    n, m = hp.nb_nodes, hp.nb_nodes + 2
    _load("grow_flow_init").main(str(src), str(tmp_path / "jax.npz"), m)
    assert grow_flow_init.main([str(src), str(tmp_path / "port.npz"), str(m), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("grow verified: max |dNLL| = ") and f"({n} -> {m} blocks" in out[-1]
    (hp_port, port), (hp_jax, jaxed), (_, source) = (read_artifact(str(tmp_path / f)) for f in (
        "port.npz", "jax.npz", "tiny_sigmoid.npz"))
    assert hp_port == hp_jax and hp_port["hyper_parameters"]["nb_nodes"] == m
    assert sorted(port) == sorted(jaxed)
    for key in port:
        block, _, layer, _ = key.split("/")
        if int(block) < n:
            assert np.array_equal(port[key], jaxed[key]) and np.array_equal(port[key], source[key]), key
        elif int(layer) == hp.coeff_fn_config:  # a new block's last layer
            assert not port[key].any() and not jaxed[key].any(), key
    # Both grown flows give the source's NLL on the same inputs.
    robot = get_robot("panda")
    rng = np.random.default_rng(0)
    low, high = robot.limits_low().numpy(), robot.limits_high().numpy()
    q = torch.from_numpy((low + rng.uniform(size=(64, 7)) * (high - low)).astype(np.float32))
    x = torch.cat([q, torch.zeros((64, hp.dim_latent_space - 7))], dim=1)
    cond = robot.forward_kinematics(q)
    ref = _nll(src, x, cond)
    for grown in ("port.npz", "jax.npz"):
        np.testing.assert_allclose(_nll(tmp_path / grown, x, cond), ref, atol=NLL_ATOL, rtol=0, err_msg=grown)


def _checkpoint_run(tmp_path, records):
    """A ``train`` run directory: one block of the default width (what the
    tool's flags build with ``--nb_nodes 1``), checkpoints at steps 10 and
    20, and ``records`` as its metrics.jsonl. -> (checkpoint dir, the
    parameters of step 20, the hyperparameters)."""
    hp = FlowHyperParams()
    hp.nb_nodes, hp.dim_latent_space, hp.sigmoid_on_output, hp.softflow_enabled = 1, 7, True, False
    flow = build_flow(hp, get_robot("panda"))
    run = tmp_path / "run"
    ckpt = run / "checkpoints"
    for step in (10, 20):
        params = flow.init(torch.Generator().manual_seed(step))
        save_checkpoint(str(ckpt), step, params, {"name": "adamw", "count": step})
    with open(run / "metrics.jsonl", "w") as f:
        f.write("".join(records))
    return ckpt, params, hp


EXPORT_ARGS = ["--robot_name", "panda", "--nb_nodes", "1", "--dim_latent_space", "7", "--sigmoid_on_output",
               "--disable_softflow", "--dtype", "float16", "--device", "cpu"]


def test_export_from_checkpoint_equals_jax_export(tmp_path, capsys):
    from ikflow_tpu.flow import FlowHyperParams as JaxHp
    from ikflow_tpu_torch.training.checkpoints import flatten_params

    records = ['{"tr/loss": 1.0, "step": 5}\n', '{"val/l2_error_mm": 31.5, "val/angular_error_deg": 9.5, "step": 10}\n',
               'not json\n', '{"val/l2_error_mm": 30.25, "val/angular_error_deg": 9.25, "step": 20}\n',
               '{"val/l2_error_mm": 1.0, "val/angular_error_deg": 0.5, "step": 30}\n']
    ckpt, params, hp = _checkpoint_run(tmp_path, records)
    out = str(tmp_path / "port.npz")
    assert export_from_checkpoint.main(["--ckpt_dir", str(ckpt), "--out", out] + EXPORT_ARGS) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"deploy gate: 100.0 mm (default backstop 100.0); val 30.25 mm at step 20 (restored step 20)",
                     f"exported {out} from checkpoint step 20"]
    # The JAX package's export of the same parameters, quality and gate.
    tree = [{s: [{k: v for k, v in lay.items()} for lay in blk[s]] for s in ("s1", "s2")} for blk in params]
    flat = flatten_params(tree)
    jparams = tuple({s: [{k: flat[f"{i}/{s}/{j}/{k}"] for k in ("w", "b")} for j in range(len(blk[s]))]
                     for s in ("s1", "s2")} for i, blk in enumerate(tree))
    quality = {"val_l2_error_mm": 30.25, "val_angular_error_deg": 9.25,
               "quality_source": "metrics.jsonl step 20 (checkpoint step 20)"}
    jax_export_deploy(str(tmp_path / "jax.npz"), jparams, JaxHp.from_dict(hp.to_dict()), "panda", global_step=20,
                      dtype="float16", quality=quality, max_val_l2_mm=100.0)
    _assert_same_artifact(out, tmp_path / "jax.npz")


def test_export_from_checkpoint_refuses_without_a_val_record(tmp_path, capsys):
    ckpt, _, _ = _checkpoint_run(tmp_path, ['{"val/l2_error_mm": 1.0, "step": 30}\n'])
    out = tmp_path / "port.npz"
    assert export_from_checkpoint.main(["--ckpt_dir", str(ckpt), "--out", str(out)] + EXPORT_ARGS) == 1
    assert capsys.readouterr().out.startswith("EXPORT REFUSED: no val record at step <= 20 in ")
    assert not out.exists()


@pytest.mark.parametrize("flags", [["--dim_latent_space", "8"], ["--nb_nodes", "2"]], ids=["latent", "blocks"])
def test_export_from_checkpoint_refuses_other_flags(tmp_path, flags):
    ckpt, _, _ = _checkpoint_run(tmp_path, ['{"val/l2_error_mm": 1.0, "step": 20}\n'])
    argv = ["--ckpt_dir", str(ckpt), "--out", str(tmp_path / "port.npz")] + EXPORT_ARGS + flags
    with pytest.raises(ValueError, match="do not fit the flags"):
        export_from_checkpoint.main(argv)


def test_stamp_warm_start_equals_jax(tmp_path, monkeypatch, capsys):
    src = tmp_path / "tiny.npz"
    _tiny_artifact(src, softflow=False, sigmoid=True, seed=1, dtype="float16", global_step=200)
    for name in ("jax.npz", "port.npz"):
        shutil.copy(src, tmp_path / name)
    monkeypatch.setattr(sys, "argv", ["stamp_warm_start.py", str(tmp_path / "jax.npz"), "base.npz", "1000"])
    assert _load("stamp_warm_start").main() == 0
    argv = [str(tmp_path / "port.npz"), "base.npz", "1000"]
    assert stamp_warm_start.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(f"{tmp_path / 'port.npz'}: stamped warm_start ")
    _assert_same_artifact(tmp_path / "port.npz", tmp_path / "jax.npz", skip_header=("warm_start",))
    (port, _), (jaxed, _) = read_artifact(str(tmp_path / "port.npz")), read_artifact(str(tmp_path / "jax.npz"))
    assert port["warm_start"] == dict(jaxed["warm_start"], stamp=stamp_warm_start.STAMP)
    assert port["warm_start"]["total_steps"] == 1200
    before = (tmp_path / "port.npz").read_bytes()
    assert stamp_warm_start.main(argv) == 0
    assert "warm_start already present" in capsys.readouterr().out
    assert (tmp_path / "port.npz").read_bytes() == before


def test_stamp_quality_headers_gate_and_keys(tmp_path, monkeypatch, capsys):
    import ikflow_tpu.registry as jax_registry
    import ikflow_tpu.training.dataset as jax_dataset
    import ikflow_tpu_torch.registry as registry
    import ikflow_tpu_torch.training.dataset as dataset
    from ikflow_tpu.solver import IKFlowSolver as JaxSolver
    from ikflow_tpu_torch.solver import IKFlowSolver

    src = tmp_path / "tiny.npz"
    jhp = _tiny_artifact(src, softflow=False, sigmoid=True, seed=2)
    jparams = jax_build_flow(jhp, jax_get_robot("panda")).init(jax.random.PRNGKey(2))
    hp = FlowHyperParams.from_dict(jhp.to_dict())
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))

    def port_solver(name, allow_uninitialized=False, device="cuda"):
        return IKFlowSolver(hp, get_robot("panda"), params=params, device=device), hp

    def jax_solver(name):
        solver = JaxSolver(jhp, jax_get_robot("panda"), seed=0)
        solver.set_params(jparams)
        return solver, jhp

    monkeypatch.setattr(registry, "get_ik_solver", port_solver)
    monkeypatch.setattr(jax_registry, "get_ik_solver", jax_solver)
    # A test split of 64 rows drawn in chunks of 1024, not 15000 in chunks of
    # 262144: validation reads its first 8.
    for module in (dataset, jax_dataset):
        monkeypatch.setattr(module, "build_dataset", functools.partial(module.build_dataset, test_set_size=64,
                                                                       chunk_size=1024))
    for name in ("jax.npz", "port.npz"):
        shutil.copy(src, tmp_path / name)
    before = (tmp_path / "port.npz").read_bytes()
    argv = ["--model_name", "tiny", "--npz", str(tmp_path / "port.npz"), "--val_set_size", "8", "--device", "cpu"]
    with pytest.raises(AssertionError, match="exceeds gate 1.0 — refusing to stamp"):
        stamp_quality_headers.main(argv + ["--gate_mm", "1.0"])
    assert (tmp_path / "port.npz").read_bytes() == before
    assert stamp_quality_headers.main(argv + ["--gate_mm", "100000.0"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("tiny: measured val l2 ") and lines[-1] == f"stamped {tmp_path / 'port.npz'}"
    monkeypatch.setattr(sys, "argv", ["stamp_quality_headers.py", "--model_name", "tiny", "--npz",
                                      str(tmp_path / "jax.npz"), "--gate_mm", "100000.0", "--val_set_size", "8"])
    assert _load("stamp_quality_headers").main() == 0
    (port, port_arrays), (jaxed, jax_arrays) = (read_artifact(str(tmp_path / f)) for f in ("port.npz", "jax.npz"))
    assert sorted(port) == sorted(jaxed) and sorted(port["quality"]) == sorted(jaxed["quality"])
    assert port["quality_gate_mm"] == jaxed["quality_gate_mm"] == 100000.0
    assert "ikflow_tpu_torch.scripts_dev.stamp_quality_headers" in port["quality_source"]
    assert all(np.array_equal(port_arrays[k], jax_arrays[k]) for k in port_arrays)
