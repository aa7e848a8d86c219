"""The FrEIA state-dict import and the reference dataset reader
(``ikflow_tpu_torch/training/torch_compat.py``) against the JAX package's
``ikflow_tpu/training/torch_compat.py``.

One synthetic FrEIA state dict, made from known weights, goes through both
imports: the arrays must be equal (exact: both transpose the same floats),
and the flow inverses of the two imports within 1e-5 (the two frameworks'
fp32 sums in another order). The mismatch errors carry the JAX package's
messages.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from ikflow_tpu.flow import build_flow as jax_build_flow, tiny_model_params as jax_tiny
from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu.training import torch_compat as jax_compat
from ikflow_tpu_torch.flow import FlowHyperParams, build_flow
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.training import torch_compat
from ikflow_tpu_torch.training.checkpoints import flatten_params


def _flows(nb_nodes=3):
    hp = jax_tiny()
    hp.dim_latent_space = 8
    hp.nb_nodes = nb_nodes
    jflow = jax_build_flow(hp, jax_get_robot("panda"))
    flow = build_flow(FlowHyperParams.from_dict(hp.to_dict()), get_robot("panda"))
    return jflow, flow


def _state_dict(flow, params, perms=True):
    """FrEIA GraphINN naming: the head at node 0, then per block its
    PermuteRandom at 2k + 1 and its GLOWCouplingBlock at 2k + 2; Sequential
    indices skip the LeakyReLU modules; weights (out, in)."""
    state = {}
    for bi, block in enumerate(params):
        if perms:
            state[f"module_list.{1 + 2 * bi}.perm"] = torch.as_tensor(np.asarray(flow._perms[bi]))
        for sub, ours in (("1", "s1"), ("2", "s2")):
            for li, layer in enumerate(block[ours]):
                state[f"module_list.{2 + 2 * bi}.subnet{sub}.{2 * li}.weight"] = layer["w"].T.contiguous()
                state[f"module_list.{2 + 2 * bi}.subnet{sub}.{2 * li}.bias"] = layer["b"].clone()
    return state


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_import_equals_jax_and_serves_the_same_inverse():
    jflow, flow = _flows()
    source = flow.init(torch.Generator().manual_seed(0))
    state = _state_dict(flow, source)
    ours = torch_compat.import_reference_state_dict(state, flow, flow.init(torch.Generator().manual_seed(1)))
    theirs = jax_compat.import_reference_state_dict({k: v.numpy() for k, v in state.items()}, jflow,
                                                    jflow.init(jax.random.PRNGKey(1)))
    flat = flatten_params(ours)
    jflat = {f"{i}/{s}/{j}/{k}": np.asarray(layer[k]) for i, blk in enumerate(theirs) for s in ("s1", "s2")
             for j, layer in enumerate(blk[s]) for k in ("w", "b")}
    assert sorted(flat) == sorted(jflat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(arr, jflat[key], err_msg=key)
    for a, b in zip(flatten_params(source).values(), flat.values()):
        np.testing.assert_array_equal(a, b)
    assert all(t.is_contiguous() for blk in ours for s in ("s1", "s2") for lay in blk[s] for t in lay.values())
    z = np.random.default_rng(2).normal(size=(16, flow.D)).astype(np.float32)
    cond = np.random.default_rng(3).normal(size=(16, flow.dim_cond)).astype(np.float32)
    q, _ = flow.inverse(ours, torch.from_numpy(z), torch.from_numpy(cond))
    jq, _ = jflow.inverse(theirs, z, cond)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5, rtol=0)


def test_mismatch_errors_carry_the_jax_messages():
    jflow, flow = _flows()
    template = flow.init(torch.Generator().manual_seed(0))
    jtemplate = jflow.init(jax.random.PRNGKey(0))
    state = _state_dict(flow, template)

    def both(bad, port_flow=flow, port_template=template, jflow_=jflow, jtemplate_=jtemplate):
        port = _message(lambda: torch_compat.import_reference_state_dict(bad, port_flow, port_template))
        jax_msg = _message(lambda: jax_compat.import_reference_state_dict(
            {k: np.asarray(v) for k, v in bad.items()}, jflow_, jtemplate_))
        return port, jax_msg

    jflow2, flow2 = _flows(nb_nodes=2)
    port, jax_msg = both(state, flow2, flow2.init(torch.Generator().manual_seed(0)), jflow2,
                         jflow2.init(jax.random.PRNGKey(0)))
    assert port == jax_msg and "coupling blocks" in port

    port, jax_msg = both({"foo": torch.zeros(3)})
    assert port == jax_msg and port.startswith("no FrEIA")

    bad = dict(state, **{"module_list.1.perm": torch.roll(state["module_list.1.perm"], 1)})
    port, jax_msg = both(bad)
    assert port == jax_msg and "permutation mismatch at block 0" in port

    bad = {k: v for k, v in state.items() if ".subnet2." not in k or not k.startswith("module_list.4.")}
    port, jax_msg = both(bad)
    assert port == jax_msg == "block 1: missing subnet2"

    bad = {k: v for k, v in state.items() if not k.startswith("module_list.2.subnet1.4.")}
    port, jax_msg = both(bad)
    assert port == jax_msg and "depth mismatch" in port

    bad = dict(state, **{"module_list.2.subnet1.0.weight": torch.zeros(3, 3)})
    port, jax_msg = both(bad)
    assert port == jax_msg and port.startswith("block 0 subnet1 layer 0: shapes (3, 3)/")


def test_permutation_buffers_are_checked_or_skipped():
    """A matching or absent permutation buffer imports; one that is not an
    index vector is skipped, as in JAX; a wrong order is refused."""
    _, flow = _flows()
    template = flow.init(torch.Generator().manual_seed(0))
    for state in (_state_dict(flow, template), _state_dict(flow, template, perms=False),
                  dict(_state_dict(flow, template), **{"module_list.1.perm": torch.zeros(8)})):
        torch_compat.import_reference_state_dict(state, flow, template)
    bad = dict(_state_dict(flow, template), **{"module_list.3.perm": torch.arange(8)})
    with pytest.raises(ValueError, match="permutation mismatch at block 1"):
        torch_compat.import_reference_state_dict(bad, flow, template)


@pytest.mark.parametrize("writer", ["torch.save", "pickle"])
def test_load_reference_pickle_reads_both_formats(tmp_path, writer):
    _, flow = _flows()
    state = _state_dict(flow, flow.init(torch.Generator().manual_seed(0)))
    path = str(tmp_path / "model.pkl")
    if writer == "torch.save":
        torch.save(state, path)
    else:
        with open(path, "wb") as f:
            pickle.dump(state, f)
    loaded = torch_compat.load_reference_pickle(path)
    assert sorted(loaded) == sorted(state)
    for k in state:
        torch.testing.assert_close(loaded[k], state[k], rtol=0, atol=0)
    imported = torch_compat.import_reference_state_dict(path, flow, flow.init(torch.Generator().manual_seed(1)))
    for a, b in zip(flatten_params(imported).values(),
                    flatten_params(torch_compat.import_reference_state_dict(state, flow, imported)).values()):
        np.testing.assert_array_equal(a, b)


def test_load_reference_dataset_pt(tmp_path):
    shapes = {"samples_tr": (100, 7), "endpoints_tr": (100, 7), "samples_te": (20, 7), "endpoints_te": (20, 7)}
    tensors = {name: torch.randn(shape, generator=torch.Generator().manual_seed(i))
               for i, (name, shape) in enumerate(shapes.items())}
    for name, t in tensors.items():
        torch.save(t, os.path.join(tmp_path, f"{name}.pt"))
    ds = torch_compat.load_reference_dataset(str(tmp_path), "panda")
    jds = jax_compat.load_reference_dataset(str(tmp_path), "panda")
    assert ds.robot_name == jds.robot_name == "panda" and ds.n_train == 100
    for name, t in tensors.items():
        np.testing.assert_array_equal(getattr(ds, name), t.numpy())
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name))
    os.remove(os.path.join(tmp_path, "samples_te.pt"))
    with pytest.raises(FileNotFoundError):
        torch_compat.load_reference_dataset(str(tmp_path), "panda")
