"""Parity of the port's flow, subnet MLP and deploy reader with the JAX package.

The plain subnet is held against JAX's ``fused_mlp`` in interpret mode and
against ``apply_subnet``; the flow's ``inverse`` and ``forward`` (with logdet)
against JAX's on the same parameters (``params_from_jax``). Tolerance atol
1e-4: fp32 matmuls summed in another order."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.flow import apply_subnet, build_flow as jax_build_flow, tiny_model_params as jax_tiny
from ikflow_tpu.flow.pallas_subnet import fused_mlp as jax_fused_mlp, pad_subnet_params
from ikflow_tpu.robots import get_robot as jax_get_robot
from ikflow_tpu.training.checkpoints import load_deploy as jax_load_deploy
from ikflow_tpu_torch.training.checkpoints import load_deploy, params_from_jax, read_deploy_header
from ikflow_tpu_torch.flow import build_flow, fused_mlp, fused_mlp_plain, tiny_model_params
from ikflow_tpu_torch.flow import fused_subnet
from ikflow_tpu_torch.robots import get_robot

ATOL = 1e-4


def _np_subnet(rng, dims):
    return [
        {"w": (rng.uniform(-1, 1, size=(dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32),
         "b": (rng.uniform(-1, 1, size=(dims[i + 1],)) / np.sqrt(dims[i])).astype(np.float32)}
        for i in range(len(dims) - 1)
    ]


def _torch_layers(layers):
    return [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in layers]


@pytest.mark.parametrize("dims", [(10, 256, 256, 256, 8), (11, 256, 256, 256, 6), (12, 128, 128, 10)])
def test_plain_subnet_matches_jax(dims):
    rng = np.random.default_rng(sum(dims))
    layers = _np_subnet(rng, dims)
    x = rng.normal(size=(37, dims[0])).astype(np.float32)
    out = fused_mlp_plain(torch.from_numpy(x), _torch_layers(layers)).numpy()
    jlayers = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in layers]
    ref = np.asarray(apply_subnet(jlayers, jnp.asarray(x)))
    pallas = np.asarray(jax_fused_mlp(jnp.asarray(x), pad_subnet_params(jlayers), dims[-1], tile_b=128,
                                      interpret=True))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=0)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    layers = _torch_layers(_np_subnet(rng, (10, 64, 64, 8)))
    x = torch.from_numpy(rng.normal(size=(5, 10)).astype(np.float32))
    before = fused_mlp.launches
    torch.testing.assert_close(fused_mlp(x, layers), fused_mlp_plain(x, layers), rtol=0, atol=0)
    assert fused_mlp.launches == before


def test_wrapper_refuses_other_devices():
    layers = [{"w": torch.empty(10, 64, device="meta"), "b": torch.empty(64, device="meta")}] * 2
    with pytest.raises(ValueError):
        fused_mlp(torch.empty(3, 10, device="meta"), layers)


def _bad_inputs():
    """Inputs K1 refuses (hidden width a multiple of 4 up to 1024, input
    width up to the hidden width, last width up to 16, 2..5 layers, fp32,
    contiguous)."""
    rng = np.random.default_rng(1)
    good = _torch_layers(_np_subnet(rng, (10, 64, 64, 8)))
    x = torch.zeros(4, 10)
    wide = _torch_layers(_np_subnet(rng, (10, 1028, 8)))
    ragged_width = _torch_layers(_np_subnet(rng, (10, 66, 8)))
    wide_input = _torch_layers(_np_subnet(rng, (65, 64, 8)))
    narrow_out = _torch_layers(_np_subnet(rng, (10, 64, 20)))
    half = [{k: v.half() for k, v in layer.items()} for layer in good]
    strided = [dict(layer) for layer in good]
    strided[1]["w"] = torch.zeros(64, 128)[:, ::2]
    return {
        "one_layer": (x, good[:1]),
        "six_layers": (x, _torch_layers(_np_subnet(rng, (10, 64, 64, 64, 64, 64, 8)))),
        "width_over_1024": (x, wide),
        "width_not_multiple_of_4": (x, ragged_width),
        "input_over_width": (torch.zeros(4, 65), wide_input),
        "out_over_16": (x, narrow_out),
        "fp16": (x, half),
        "non_contiguous": (x, strided),
        "input_width": (torch.zeros(4, 9), good),
        "x_1d": (torch.zeros(10), good),
    }


def test_kernel_input_checks_pass_what_k1_takes():
    rng = np.random.default_rng(2)
    for dims in [(10, 1024, 1024, 1024, 8), (11, 1024, 1024, 1024, 6), (13, 256, 256, 10), (64, 128, 16),
                 (10, 320, 320, 8), (100, 200, 200, 16), (1000, 1000, 6), (4, 4, 1)]:
        fused_subnet._check(torch.zeros(3, dims[0]), _torch_layers(_np_subnet(rng, dims)))


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_kernel_input_checks_raise(case):
    x, layers = _bad_inputs()[case]
    with pytest.raises((ValueError, TypeError)):
        fused_subnet._check(x, layers)


def _flow_pair(sigmoid, clamp_activation="atan", seed=0, bf16_hidden=False):
    hp = jax_tiny()
    hp.dim_latent_space = 7 if sigmoid else 8
    hp.sigmoid_on_output = sigmoid
    hp.softflow_enabled = not sigmoid
    hp.clamp_activation = clamp_activation
    hp.bf16_hidden = bf16_hidden
    jflow = jax_build_flow(hp, jax_get_robot("panda"))
    jparams = jflow.init(jax.random.PRNGKey(seed))
    thp = tiny_model_params()
    for k, v in hp.to_dict().items():
        setattr(thp, k, v)
    tflow = build_flow(thp, get_robot("panda"))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jflow, jparams, tflow, tparams


FLOW_CASES = [(False, "atan"), (True, "atan"), (False, "atan_scaled"), (True, "atan_scaled")]


@pytest.mark.parametrize("sigmoid,clamp", FLOW_CASES)
def test_flow_inverse_matches_jax(sigmoid, clamp):
    jflow, jparams, tflow, tparams = _flow_pair(sigmoid, clamp)
    rng = np.random.default_rng(5)
    z = rng.normal(size=(33, jflow.D)).astype(np.float32)
    cond = rng.normal(size=(33, jflow.dim_cond)).astype(np.float32)
    qj, ldj = jflow.inverse(jparams, jnp.asarray(z), jnp.asarray(cond))
    qt, ldt = tflow.inverse(tparams, torch.from_numpy(z), torch.from_numpy(cond))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("sigmoid,clamp", FLOW_CASES)
def test_flow_forward_logdet_matches_jax(sigmoid, clamp):
    jflow, jparams, tflow, tparams = _flow_pair(sigmoid, clamp, seed=1)
    rng = np.random.default_rng(6)
    robot = get_robot("panda")
    low = np.array([lo for lo, _ in robot.actuated_joints_limits])
    high = np.array([hi for _, hi in robot.actuated_joints_limits])
    x = np.zeros((33, jflow.D), np.float32)
    x[:, :7] = low + rng.uniform(0.05, 0.95, size=(33, 7)) * (high - low)
    x[:, 7:] = rng.uniform(-0.5, 0.5, size=(33, jflow.D - 7))
    cond = rng.normal(size=(33, jflow.dim_cond)).astype(np.float32)
    zj, ldj = jflow.forward(jparams, jnp.asarray(x), jnp.asarray(cond))
    zt, ldt = tflow.forward(tparams, torch.from_numpy(x), torch.from_numpy(cond))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), atol=ATOL, rtol=1e-5)
    # forward then inverse is the identity
    xr, ldr = tflow.inverse(tparams, zt, torch.from_numpy(cond))
    np.testing.assert_allclose(xr.numpy(), x, atol=ATOL, rtol=0)
    np.testing.assert_allclose((ldt + ldr).numpy(), 0.0, atol=1e-3)


def test_permutations_and_param_shapes_match_jax():
    jflow, jparams, tflow, tparams = _flow_pair(True)
    for a, b in zip(jflow._perms, tflow._perms):
        np.testing.assert_array_equal(a, b)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    for jb, tb in zip(shapes, tflow.param_shapes()):
        for s in ("s1", "s2"):
            assert [(lay["w"], lay["b"]) for lay in jb[s]] == [(lay["w"], lay["b"]) for lay in tb[s]]


def _write_artifact(path, flow_pair, robot_name="panda"):
    jflow, jparams, _, _ = flow_pair
    flat = {}
    for i, block in enumerate(jparams):
        for s in ("s1", "s2"):
            for j, layer in enumerate(block[s]):
                for k in ("w", "b"):
                    flat[f"{i}/{s}/{j}/{k}"] = np.asarray(layer[k]).astype(np.float16)
    header = {"format_version": 1, "robot_name": robot_name, "hyper_parameters": jflow.hp.to_dict(),
              "stored_dtype": "float16"}
    np.savez_compressed(path, __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8), **flat)
    return header


def test_load_deploy_matches_jax(tmp_path):
    pair = _flow_pair(True)
    path = str(tmp_path / "tiny.npz")
    header = _write_artifact(path, pair)
    jflow, jparams, tflow, _ = pair
    jloaded, jheader = jax_load_deploy(path, jparams)
    tloaded, theader = load_deploy(path, tflow.param_shapes(), device="cpu")
    assert theader == jheader == header == read_deploy_header(path)
    for jb, tb in zip(jloaded, tloaded):
        for s in ("s1", "s2"):
            for jl, tl in zip(jb[s], tb[s]):
                for k in ("w", "b"):
                    assert tl[k].dtype == torch.float32 and tl[k].is_contiguous()
                    np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))


def test_load_deploy_rejects_wrong_shapes(tmp_path):
    pair = _flow_pair(True)
    path = str(tmp_path / "tiny.npz")
    _write_artifact(path, pair)
    other = tiny_model_params()
    other.dim_latent_space = 8
    with pytest.raises(ValueError, match="shape mismatch"):
        load_deploy(path, build_flow(other, get_robot("panda")).param_shapes(), device="cpu")
    assert read_deploy_header(str(tmp_path / "missing.npz")) is None
