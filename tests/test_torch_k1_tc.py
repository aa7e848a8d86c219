"""The arithmetic of K1's tensor-core route, emulated in plain torch on the CPU.

K1 (``csrc/fused_mlp.cu``) runs each width x width layer as 3xTF32: both
operands are split into hi = rna_tf32(v) and lo = rna_tf32(v - hi), and
hi*hi + hi*lo + lo*hi is summed in fp32 (TF32 products are exact in fp32).
The emulation below does the same on the fp32 bit patterns. It is held to the
fp32 contract: within 1e-4 (atol and rtol, as on the card) of
``fused_mlp_plain`` and within 1e-5 of a float64 reference (relative to the
largest output), on the shipped
``panda__full__sigmoid`` subnets at 256 rows, and to the JAX Pallas kernel in
interpret mode. Plain TF32 (hi*hi only) is shown to miss the float64
reference by far more, which is why the route takes three products. The
kernel itself runs only on the card (``tests/test_torch_gpu.py``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ikflow_tpu.flow.pallas_subnet import fused_mlp as jax_fused_mlp, pad_subnet_params
from ikflow_tpu_torch import registry
from ikflow_tpu_torch.flow import fused_mlp_plain
from ikflow_tpu_torch.flow.fused_subnet import (
    LEAKY_SLOPE,
    pack_tf32x3_weight,
    prepare_tf32x3_subnet,
    split_tf32 as package_split_tf32,
)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep the top 19 bits of the fp32 pattern, rounding
    to nearest with ties away from zero (add half of the dropped range to
    the magnitude bits, then truncate)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def matmul_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    ah, al = split_tf32(a)
    wh, wl = split_tf32(w)
    return (al @ wh + ah @ wl) + ah @ wh


def subnet_route(x, layers, passes=3):
    """K1's function: fp32 first and last layer, the hidden layers through
    3xTF32 (``passes=1``: plain TF32, for contrast), LeakyReLU between."""
    h, n = x, len(layers)
    for i, layer in enumerate(layers):
        if 0 < i < n - 1:
            acc = matmul_3xtf32(h, layer["w"]) if passes == 3 else round_tf32(h) @ round_tf32(layer["w"])
            h = acc + layer["b"]
        else:
            h = torch.addmm(layer["b"], h, layer["w"])
        if i < n - 1:
            h = F.leaky_relu(h, LEAKY_SLOPE)
    return h


def subnet_float64(x, layers):
    h = x.double()
    for i, layer in enumerate(layers):
        h = torch.addmm(layer["b"].double(), h, layer["w"].double())
        if i < len(layers) - 1:
            h = F.leaky_relu(h, LEAKY_SLOPE)
    return h


def test_round_tf32_is_rna_on_the_bit_pattern():
    ulp = 2.0**-10  # tf32 keeps 10 mantissa bits
    x = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4, 1.0 + 3 * ulp / 4, 3.0, -0.0,
                      2.0 - ulp / 4, 1.5 * 2.0**-100], dtype=torch.float32)
    want = [1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp, 3.0, -0.0, 2.0, 1.5 * 2.0**-100]
    assert round_tf32(x).tolist() == want
    r = round_tf32(torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32)))
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_split_recovers_fp32():
    x = torch.from_numpy(np.random.default_rng(1).normal(scale=3.0, size=65536).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert float((rest / x.double().abs()).max()) <= 2.0**-21
    # the dropped lo*lo term is below 2^-20 of each product
    assert float(((lo.double() / hi.double()).abs()).max()) <= 2.0**-10


def test_package_split_is_the_kernel_rule():
    x = torch.from_numpy(np.random.default_rng(2).normal(scale=5.0, size=(64, 256)).astype(np.float32))
    hi, lo = package_split_tf32(x)
    want_hi, want_lo = split_tf32(x)
    assert torch.equal(hi.view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), want_lo.view(torch.int32))


@pytest.mark.parametrize("K,N", [(32, 128), (64, 256), (1024, 1024), (320, 320), (1000, 1000), (36, 200)])
def test_pack_tf32x3_weight_is_the_kernel_layout(K, N):
    """The weight zero-padded to multiples of 128; chunk j (32 rows) of CTA
    slice c (128 columns): the hi plane, then the lo plane, each in wgmma's
    K-major core-matrix order: element (n, k) of the slice at word
    ((n // 8) * 8 + k // 4) * 32 + (n % 8) * 4 + k % 4."""
    w = torch.from_numpy(np.random.default_rng(K + N).normal(size=(K, N)).astype(np.float32))
    packed = pack_tf32x3_weight(w).numpy()
    Kp, Np = -(-K // 128) * 128, -(-N // 128) * 128
    planes = [np.pad(p.numpy(), ((0, Kp - K), (0, Np - N))) for p in split_tf32(w)]
    n_chunks = Kp // 32
    c, j, p, n, k = np.meshgrid(np.arange(Np // 128), np.arange(n_chunks), np.arange(2), np.arange(128),
                                np.arange(32), indexing="ij")
    word = ((c * n_chunks + j) * 2 + p) * 4096 + ((n // 8) * 8 + k // 4) * 32 + (n % 8) * 4 + k % 4
    want = np.where(p == 0, planes[0][32 * j + k, 128 * c + n], planes[1][32 * j + k, 128 * c + n])
    assert packed.shape == (2 * Kp * Np,) and packed.dtype == np.float32
    np.testing.assert_array_equal(packed[word.ravel()], want.ravel())


def test_prepare_tf32x3_subnet_packs_hidden_layers_only():
    rng = np.random.default_rng(3)
    dims = (10, 256, 256, 256, 8)
    layers = [{"w": torch.from_numpy(rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)),
               "b": torch.zeros(dims[i + 1])} for i in range(4)]
    prepared = prepare_tf32x3_subnet(layers)
    assert [("wp" in lay) for lay in prepared] == [False, True, True, False]
    assert torch.equal(prepared[1]["wp"], pack_tf32x3_weight(layers[1]["w"])) and prepared[1]["w"] is layers[1]["w"]
    assert pack_tf32x3_weight(torch.ones(40, 130)).numel() == 2 * 128 * 256  # zero-padded to multiples of 128


@pytest.fixture(scope="module")
def shipped_subnets():
    path = registry.resolve_weights_path(registry.model_descriptions()["panda__full__sigmoid"])
    if not os.path.exists(path):
        pytest.skip("panda__full_sigmoid.npz is not in the model search path")
    solver, _ = registry.get_ik_solver("panda__full__sigmoid", device="cpu")
    return solver.params


@pytest.mark.parametrize("block,subnet", [(0, "s1"), (0, "s2"), (5, "s1"), (5, "s2"), (11, "s1"), (11, "s2")])
def test_3xtf32_route_meets_the_fp32_contract(shipped_subnets, block, subnet):
    """256 rows through a shipped subnet (10|11 -> 1024 x 3 -> 8|6), against
    the plain fp32 version with K1's tolerance, and against float64 within
    1e-5 of the largest output: block 5's s1 gives outputs near 1100 on
    unit-normal inputs, where plain fp32 itself is 3.6e-4 away from float64
    (1e-5 absolute would refuse fp32)."""
    layers = shipped_subnets[block][subnet]
    x = torch.from_numpy(np.random.default_rng(block).normal(size=(256, layers[0]["w"].shape[0])).astype(np.float32))
    route = subnet_route(x, layers)
    ref64 = subnet_float64(x, layers)
    torch.testing.assert_close(route, fused_mlp_plain(x, layers), atol=1e-4, rtol=1e-4)
    scale = max(1.0, float(ref64.abs().max()))
    route_err = float((route.double() - ref64).abs().max())
    assert route_err <= 1e-5 * scale
    tf32_err = float((subnet_route(x, layers, passes=1).double() - ref64).abs().max())
    assert tf32_err >= 50 * route_err


@pytest.mark.parametrize("dims", [(10, 256, 256, 256, 8), (13, 128, 128, 10), (10, 320, 320, 8), (100, 200, 200, 16)])
def test_3xtf32_route_matches_the_pallas_kernel(dims):
    rng = np.random.default_rng(sum(dims))
    layers = [{"w": (rng.uniform(-1, 1, size=(dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32),
               "b": (rng.uniform(-1, 1, size=(dims[i + 1],)) / np.sqrt(dims[i])).astype(np.float32)}
              for i in range(len(dims) - 1)]
    x = rng.normal(size=(37, dims[0])).astype(np.float32)
    route = subnet_route(torch.from_numpy(x), [{k: torch.from_numpy(v) for k, v in lay.items()} for lay in layers])
    jlayers = [{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers]
    pallas = np.asarray(jax_fused_mlp(jnp.asarray(x), pad_subnet_params(jlayers), dims[-1], tile_b=128,
                                      interpret=True))
    np.testing.assert_allclose(route.numpy(), pallas, atol=1e-4, rtol=1e-4)


def _pad_subnet(layers, width):
    """K1's view of a subnet whose hidden width is padded to ``width``: the
    first layer's columns, the hidden weights' rows and columns, the last
    layer's rows and the hidden biases, all padded with zeros."""
    n, out = len(layers), []
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        K = w.shape[0] if i == 0 else width
        N = w.shape[1] if i == n - 1 else width
        out.append({"w": F.pad(w, (0, N - w.shape[1], 0, K - w.shape[0])), "b": F.pad(b, (0, N - b.shape[0]))})
    return out


@pytest.mark.parametrize("dims", [(10, 320, 320, 8), (11, 1000, 1000, 1000, 6), (100, 200, 200, 16), (13, 4, 4, 3),
                                  (20, 36, 5)])
def test_zero_padding_to_128_columns_is_exact(dims):
    """K1 runs a width that is no multiple of 128 on weights zero-padded to
    the next one (``pack_tf32x3_weight``, and the masked first and last layer
    loads): every padded activation is LeakyReLU(0) = 0, so the route's
    output is the unpadded route's, to the last bit up to the order of fp32
    sums."""
    rng = np.random.default_rng(sum(dims))
    layers = [{"w": torch.from_numpy((rng.uniform(-1, 1, size=(dims[i], dims[i + 1])) / np.sqrt(dims[i]))
                                     .astype(np.float32)),
               "b": torch.from_numpy((rng.uniform(-1, 1, size=(dims[i + 1],)) / np.sqrt(dims[i])).astype(np.float32))}
              for i in range(len(dims) - 1)]
    x = torch.from_numpy(rng.normal(size=(65, dims[0])).astype(np.float32))
    width = -(-dims[1] // 128) * 128
    padded = _pad_subnet(layers, width)
    if len(dims) > 3:
        assert torch.equal(pack_tf32x3_weight(layers[1]["w"]), pack_tf32x3_weight(padded[1]["w"]))
    torch.testing.assert_close(subnet_route(x, padded), subnet_route(x, layers), atol=1e-6, rtol=1e-6)
