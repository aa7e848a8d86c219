"""The arithmetic of K1' (``csrc/fused_mlp_bf16.cu``) on its packed weights,
emulated in plain torch on the CPU.

K1' reads each width x width weight from ``pack_bf16_weight``: zero-padded to
multiples of 128, rounded to bf16 and laid out in wgmma's K-major core-matrix
order, one 16 KB block per (128-column CTA slice, 64-row chunk). The
emulation below unpacks those blocks and computes what the kernel computes:
the first layer in fp32 on the padded width (its padded columns read as
zero), each hidden layer on its input rounded to bf16 with exact products
summed in fp32, then the bias and the LeakyReLU, and the last layer in fp32
over the padded rows. It is held to the JAX Pallas kernel in interpret mode
(``bf16_hidden=True``) and to ``fused_mlp_bf16_plain``, with the two-condition
tolerance of ``tests/test_torch_bf16.py`` (sums in another order may flip a
bf16 rounding now and then). The kernel itself runs only on the card
(``tests/test_torch_gpu.py``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ikflow_tpu.flow.pallas_subnet import fused_mlp as jax_fused_mlp, pad_subnet_params
from ikflow_tpu_torch import registry
from ikflow_tpu_torch.flow import fused_mlp_bf16_plain, prepare_bf16_subnet
from ikflow_tpu_torch.flow.fused_subnet import LEAKY_SLOPE, pack_bf16_weight
from test_torch_bf16 import assert_bf16_close
from test_torch_flow import _np_subnet, _torch_layers


def _padded(n):
    return -(-n // 128) * 128


def unpack_bf16_weight(packed: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The padded (K', N') bf16 weight that K1' reads, from its packed blocks
    [c][j][n // 8][k // 8][n % 8][k % 8]."""
    Kp, Np = _padded(K), _padded(N)
    blocks = packed.reshape(Np // 128, Kp // 64, 16, 8, 8, 8)  # [c, j, nb, kb, n8, k8]
    return blocks.permute(1, 3, 5, 0, 2, 4).reshape(Kp, Np)  # [j, kb, k8, c, nb, n8]


def subnet_route_bf16(x, layers):
    """K1''s function on a prepared subnet, as the kernel computes it."""
    n, width = len(layers), layers[0]["w"].shape[1]
    P = _padded(width)
    h = x
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        if 0 < i < n - 1:
            h = h.to(torch.bfloat16).float() @ unpack_bf16_weight(layer["wp"], width, width).float()
        else:
            K = w.shape[0] if i == 0 else P
            N = w.shape[1] if i == n - 1 else P
            h = h @ F.pad(w, (0, N - w.shape[1], 0, K - w.shape[0]))
        h = h + F.pad(b, (0, h.shape[1] - b.shape[0]))
        if i < n - 1:
            h = F.leaky_relu(h, LEAKY_SLOPE)
    return h


@pytest.mark.parametrize("K,N", [(16, 8), (64, 128), (1024, 1024), (320, 320), (1000, 1000), (36, 200)])
def test_pack_bf16_weight_is_the_kernel_layout(K, N):
    """The weight zero-padded to multiples of 128 and rounded to bf16 (to
    nearest even); chunk j (64 rows) of CTA slice c (128 columns) is one block
    of 8192 values in wgmma's K-major core-matrix order: element (n, k) of
    the block at ((n // 8) * 8 + k // 8) * 64 + (n % 8) * 8 + k % 8."""
    w = torch.from_numpy(np.random.default_rng(K + N).normal(size=(K, N)).astype(np.float32))
    packed = pack_bf16_weight(w)
    Kp, Np = _padded(K), _padded(N)
    wb = F.pad(w, (0, Np - N, 0, Kp - K)).to(torch.bfloat16).view(torch.int16).numpy()
    n_chunks = Kp // 64
    c, j, n, k = np.meshgrid(np.arange(Np // 128), np.arange(n_chunks), np.arange(128), np.arange(64), indexing="ij")
    index = (c * n_chunks + j) * 8192 + ((n // 8) * 8 + k // 8) * 64 + (n % 8) * 8 + k % 8
    assert packed.shape == (Kp * Np,) and packed.dtype == torch.bfloat16 and packed.is_contiguous()
    got = packed.view(torch.int16).numpy()
    np.testing.assert_array_equal(got[index.ravel()], wb[64 * j + k, 128 * c + n].ravel())
    assert torch.equal(unpack_bf16_weight(packed, K, N).view(torch.int16), torch.from_numpy(wb))


@pytest.mark.parametrize("dims", [(10, 320, 320, 8), (11, 1000, 1000, 1000, 6), (100, 200, 200, 16), (13, 4, 4, 3),
                                  (20, 36, 5)])
def test_zero_padding_to_128_columns_is_exact(dims):
    """K1' runs a width that is no multiple of 128 on weights zero-padded to
    the next one: every padded activation is LeakyReLU(0) = 0, so the route on
    the padded subnet is the route on the subnet itself, and the packed
    weights are the same."""
    rng = np.random.default_rng(sum(dims))
    layers = prepare_bf16_subnet(_torch_layers(_np_subnet(rng, dims)))
    P = _padded(dims[1])
    padded = []
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        K = w.shape[0] if i == 0 else P
        N = w.shape[1] if i == len(layers) - 1 else P
        padded.append({"w": F.pad(w, (0, N - w.shape[1], 0, K - w.shape[0])), "b": F.pad(b, (0, N - b.shape[0]))})
    padded = prepare_bf16_subnet(padded)
    for lay, pad in zip(layers[1:-1], padded[1:-1]):
        assert torch.equal(lay["wp"].view(torch.int16), pad["wp"].view(torch.int16))
    x = torch.from_numpy(rng.normal(size=(65, dims[0])).astype(np.float32))
    torch.testing.assert_close(subnet_route_bf16(x, padded), subnet_route_bf16(x, layers), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dims", [(11, 1024, 1024, 1024, 8), (65, 1024, 1024, 6), (11, 320, 320, 320, 6),
                                  (100, 320, 320, 16), (11, 40, 40, 40, 8), (20, 40, 40, 5)])
def test_bf16_route_matches_the_pallas_kernel(dims):
    rng = np.random.default_rng(sum(dims) + 1)
    layers = _np_subnet(rng, dims)
    x = rng.normal(size=(37, dims[0])).astype(np.float32)
    route = subnet_route_bf16(torch.from_numpy(x), prepare_bf16_subnet(_torch_layers(layers)))
    jlayers = [{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers]
    pallas = np.asarray(jax_fused_mlp(jnp.asarray(x), pad_subnet_params(jlayers), dims[-1], tile_b=128,
                                      bf16_hidden=True, interpret=True))
    assert route.shape == pallas.shape
    assert_bf16_close(route.numpy(), pallas)


@pytest.fixture(scope="module")
def shipped_subnets():
    path = registry.resolve_weights_path(registry.model_descriptions()["panda__full__sigmoid"])
    if not os.path.exists(path):
        pytest.skip("panda__full_sigmoid.npz is not in the model search path")
    solver, _ = registry.get_ik_solver("panda__full__sigmoid", device="cpu")
    return solver.params


@pytest.mark.parametrize("block,subnet", [(0, "s1"), (0, "s2"), (5, "s1"), (5, "s2"), (11, "s1"), (11, "s2")])
def test_bf16_route_matches_plain_on_shipped_subnets(shipped_subnets, block, subnet):
    """256 rows through a shipped subnet (10|11 -> 1024 x 3 -> 8|6): the route
    on the packed weights against ``fused_mlp_bf16_plain`` on the fp32 ones."""
    layers = shipped_subnets[block][subnet]
    x = torch.from_numpy(np.random.default_rng(block).normal(size=(256, layers[0]["w"].shape[0])).astype(np.float32))
    route = subnet_route_bf16(x, prepare_bf16_subnet(layers))
    plain = fused_mlp_bf16_plain(x, layers)
    err = (route - plain).abs()
    scale = max(1.0, float(plain.abs().max()))
    assert float(err.max()) <= 2e-3 * scale
    assert float((err <= 1e-5 * scale).float().mean()) >= 0.9
