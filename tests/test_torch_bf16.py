"""Parity of the port's bf16-hidden subnet (K1''s plain version), its weight
packing, and the bf16 flow and solver with the JAX package's ``bf16_hidden``.

Tolerance (``assert_bf16_close``): the port rounds the same operands to bf16
as JAX and sums exact products in fp32, but in another order, so an
activation within an fp32 ulp of a bf16 rounding boundary can round the other
way. Most values agree to 1e-5 (measured: 97-100% of q entries, and every
subnet output to 2.5e-7), while one such flip moves the flow's q by up to
5e-4 (measured 4.7e-4). So at least 90% of the values must agree to 1e-5 and
all to 2e-3. The fp32 flow on the same inputs meets neither: 0-3% of its q
entries lie within 1e-5 of the bf16 flow's, with a median gap of 2e-4 to 9e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ikflow_tpu.flow import apply_subnet
from ikflow_tpu.flow.pallas_subnet import fused_mlp as jax_fused_mlp, pad_subnet_params
from ikflow_tpu_torch.training.checkpoints import params_from_jax
from ikflow_tpu_torch.flow import fused_mlp_bf16, fused_mlp_bf16_plain, fused_mlp_plain, prepare_bf16_subnet
from ikflow_tpu_torch.flow import fused_subnet
from ikflow_tpu_torch.flow.fused_subnet import pack_bf16_weight
from ikflow_tpu_torch.robots import get_robot
from test_torch_flow import _flow_pair, _np_subnet, _torch_layers
from test_torch_solver import _reachable, _solver_pair

TIGHT, TIGHT_SHARE, LOOSE = 1e-5, 0.9, 2e-3


def assert_bf16_close(actual, expected):
    err = np.abs(np.asarray(actual, np.float64) - np.asarray(expected, np.float64))
    assert err.max() <= LOOSE, f"max abs err {err.max()} > {LOOSE}"
    assert (err <= TIGHT).mean() >= TIGHT_SHARE, f"only {(err <= TIGHT).mean():.3f} of values within {TIGHT}"


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_bf16_plain_subnet_matches_jax(depth):
    width = 64 if depth % 2 else 128
    dims = (11,) + (width,) * depth + (6,)
    rng = np.random.default_rng(depth)
    layers = _np_subnet(rng, dims)
    x = rng.normal(size=(37, dims[0])).astype(np.float32)
    out = fused_mlp_bf16_plain(torch.from_numpy(x), _torch_layers(layers)).numpy()
    jlayers = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in layers]
    ref = np.asarray(apply_subnet(jlayers, jnp.asarray(x), bf16_hidden=True))
    pallas = np.asarray(jax_fused_mlp(jnp.asarray(x), pad_subnet_params(jlayers), dims[-1], tile_b=128,
                                      bf16_hidden=True, interpret=True))
    assert_bf16_close(out, ref)
    assert_bf16_close(out, pallas)
    fp32 = fused_mlp_plain(torch.from_numpy(x), _torch_layers(layers)).numpy()
    if depth == 1:  # no hidden x hidden layer: K1''s function is K1's
        np.testing.assert_allclose(out, fp32, atol=TIGHT, rtol=0)
    else:
        assert np.median(np.abs(out - fp32)) > 2 * TIGHT


def test_prepare_bf16_subnet_packs_hidden_layers_only():
    layers = _torch_layers(_np_subnet(np.random.default_rng(0), (10, 64, 64, 64, 8)))
    prepared = prepare_bf16_subnet(layers)
    assert ["wp" in layer for layer in prepared] == [False, True, True, False]
    assert all("wp" not in layer for layer in layers)  # the caller's dicts are not touched
    for layer, prep in zip(layers, prepared):
        assert prep["w"] is layer["w"] and prep["b"] is layer["b"]


def test_bf16_wrapper_takes_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(0)
    layers = prepare_bf16_subnet(_torch_layers(_np_subnet(rng, (10, 64, 64, 64, 8))))
    x = torch.from_numpy(rng.normal(size=(5, 10)).astype(np.float32))
    before = fused_mlp_bf16.launches
    torch.testing.assert_close(fused_mlp_bf16(x, layers), fused_mlp_bf16_plain(x, layers), rtol=0, atol=0)
    assert fused_mlp_bf16.launches == before
    with pytest.raises(ValueError):
        fused_mlp_bf16(torch.empty(3, 10, device="meta"), layers)


def _bad_bf16_inputs():
    rng = np.random.default_rng(1)
    good = prepare_bf16_subnet(_torch_layers(_np_subnet(rng, (10, 64, 64, 8))))
    x = torch.zeros(4, 10)
    unpacked = _torch_layers(_np_subnet(rng, (10, 64, 64, 8)))
    width_66 = prepare_bf16_subnet(_torch_layers(_np_subnet(rng, (10, 66, 66, 8))))
    wide_in = prepare_bf16_subnet(_torch_layers(_np_subnet(rng, (130, 128, 128, 8))))
    fp32_packed = [dict(layer) for layer in good]
    fp32_packed[1]["wp"] = fp32_packed[1]["wp"].float()
    short_packed = [dict(layer) for layer in good]
    short_packed[1]["wp"] = short_packed[1]["wp"][:-8]
    return {
        "no_packed_weight": (x, unpacked),
        "width_not_multiple_of_4": (x, width_66),
        "input_over_width": (torch.zeros(4, 130), wide_in),
        "packed_not_bf16": (x, fp32_packed),
        "packed_wrong_size": (x, short_packed),
        "x_fp64": (x.double(), good),
        "six_layers": (x, good[:1] + good[1:2] * 4 + good[-1:]),
    }


@pytest.mark.parametrize("case", sorted(_bad_bf16_inputs()))
def test_bf16_kernel_input_checks_raise(case):
    x, layers = _bad_bf16_inputs()[case]
    with pytest.raises((ValueError, TypeError)):
        fused_subnet._check_bf16(x, layers)


@pytest.mark.parametrize("dims", [(10, 40, 40, 8), (65, 128, 128, 8), (100, 200, 200, 200, 16), (20, 36, 5)])
def test_bf16_kernel_input_checks_pass_what_it_takes(dims):
    """K1' takes what K1 takes: any hidden width that is a multiple of 4 up to
    1024 (its packed weights zero-padded to multiples of 128) and inputs up to
    the hidden width."""
    layers = prepare_bf16_subnet(_torch_layers(_np_subnet(np.random.default_rng(2), dims)))
    fused_subnet._check_bf16(torch.zeros(4, dims[0]), layers)


def _bf16_flow_pair(sigmoid, clamp, seed):
    jflow, jparams, tflow, tparams = _flow_pair(sigmoid, clamp, seed=seed, bf16_hidden=True)
    assert jflow.hp.bf16_hidden and tflow.hp.bf16_hidden
    return jflow, jparams, tflow, tparams


@pytest.mark.parametrize("sigmoid,clamp", [(False, "atan"), (True, "atan_scaled")])
def test_bf16_flow_inverse_matches_jax(sigmoid, clamp):
    jflow, jparams, tflow, tparams = _bf16_flow_pair(sigmoid, clamp, seed=2)
    rng = np.random.default_rng(7)
    z = rng.normal(size=(33, jflow.D)).astype(np.float32)
    cond = rng.normal(size=(33, jflow.dim_cond)).astype(np.float32)
    qj, ldj = jflow.inverse(jparams, jnp.asarray(z), jnp.asarray(cond))
    qt, ldt = tflow.inverse(tflow.kernel_params(tparams), torch.from_numpy(z), torch.from_numpy(cond))
    assert_bf16_close(qt.numpy(), np.asarray(qj))
    assert_bf16_close(ldt.numpy(), np.asarray(ldj))


@pytest.mark.parametrize("sigmoid,clamp", [(False, "atan"), (True, "atan_scaled")])
def test_bf16_flow_forward_logdet_matches_jax(sigmoid, clamp):
    jflow, jparams, tflow, tparams = _bf16_flow_pair(sigmoid, clamp, seed=3)
    rng = np.random.default_rng(8)
    low, high = np.array(get_robot("panda").actuated_joints_limits).T
    x = np.zeros((33, jflow.D), np.float32)
    x[:, :7] = low + rng.uniform(0.05, 0.95, size=(33, 7)) * (high - low)
    x[:, 7:] = rng.uniform(-0.5, 0.5, size=(33, jflow.D - 7))
    cond = rng.normal(size=(33, jflow.dim_cond)).astype(np.float32)
    zj, ldj = jflow.forward(jparams, jnp.asarray(x), jnp.asarray(cond))
    zt, ldt = tflow.forward(tparams, torch.from_numpy(x), torch.from_numpy(cond))
    assert_bf16_close(zt.numpy(), np.asarray(zj))
    assert_bf16_close(ldt.numpy(), np.asarray(ldj))
    # forward then inverse is the identity: a coupling's inverse feeds its
    # subnets the same inputs as its forward, up to fp32 rounding
    xr, _ = tflow.inverse(tflow.kernel_params(tparams), zt, torch.from_numpy(cond))
    assert_bf16_close(xr.numpy(), x)


@pytest.mark.parametrize("sigmoid", [False, True])
def test_bf16_solver_explicit_latent_matches_jax(sigmoid):
    js, ts = _solver_pair(sigmoid, bf16_hidden=True)
    poses = _reachable(24, seed=4).numpy()
    latent = np.random.default_rng(5).normal(size=(24, ts.network_width)).astype(np.float32)
    out_t = ts.generate_ik_solutions(poses, latent=torch.from_numpy(latent), return_detailed=True)
    out_j = js.generate_ik_solutions(jnp.asarray(poses), latent=jnp.asarray(latent), return_detailed=True,
                                     allow_uninitialized=True)
    assert len(out_t) == len(out_j) == 5  # solutions, pos, rot, limits, self_colliding
    for t, j in zip(out_t, out_j):
        assert_bf16_close(t.numpy(), np.asarray(j))


def test_set_params_rebuilds_the_packed_weights():
    js, ts = _solver_pair(True, bf16_hidden=True)
    first = ts._kernel_params[0]["s1"][1]["wp"]
    assert torch.equal(first, pack_bf16_weight(ts.params[0]["s1"][1]["w"]))  # built by the constructor
    tparams = params_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, js.params))
    ts._weights_loaded = False
    ts.set_params(tparams)
    assert ts._weights_loaded and ts.params is tparams
    packed = ts._kernel_params[0]["s1"][1]["wp"]
    assert torch.equal(packed, pack_bf16_weight(tparams[0]["s1"][1]["w"])) and not torch.equal(packed, first)
    ts.params = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params))  # plain assignment too
    assert torch.equal(ts._kernel_params[0]["s1"][1]["wp"], first)
