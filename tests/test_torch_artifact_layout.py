"""Every shipped deploy artifact (``models/*.npz``) gives the port parameters
that the card's kernel wrappers take: some artifacts store a layer's weight
in column-major order, and the wrappers read only contiguous tensors. The
wrappers' checks (``_check``, ``_check_packed``) run here on CPU tensors,
where the wrappers themselves would take the plain version."""

import os

import numpy as np
import pytest
import torch

from ikflow_tpu_torch import registry
from ikflow_tpu_torch.flow import fused_subnet
from ikflow_tpu_torch.flow.fused_subnet import prepare_bf16_subnet, prepare_tf32x3_subnet
from ikflow_tpu_torch.training.checkpoints import load_deploy

PREPARED = (
    (prepare_tf32x3_subnet, torch.float32, fused_subnet._tf32x3_numel, "prepare_tf32x3_subnet"),
    (prepare_bf16_subnet, torch.bfloat16, fused_subnet._bf16_numel, "prepare_bf16_subnet"),
)


@pytest.mark.parametrize("name", registry.get_all_model_names())
def test_shipped_artifact_loads_as_the_kernels_read_it(name):
    entry = registry.model_descriptions()[name]
    path = registry.resolve_weights_path(entry)
    if not os.path.exists(path):
        pytest.skip(f"{entry['weights_path']} is not in the model search path")
    solver, _ = registry.get_ik_solver(name, device="cpu")
    params = solver.params
    for block in params:
        for s in ("s1", "s2"):
            for layer in block[s]:
                assert layer["w"].is_contiguous() and layer["b"].is_contiguous()
                assert layer["w"].dtype == torch.float32
    with np.load(path) as z:
        column_major = [k for k in z.files if z[k].ndim == 2 and not z[k].flags.c_contiguous]
    for key in column_major[:2]:  # the values survive the change of order
        i, s, j, leaf = key.split("/")
        with np.load(path) as z:
            want = np.asarray(z[key], dtype=np.float32)
        np.testing.assert_array_equal(params[int(i)][s][int(j)][leaf].numpy(), want)
    for prepare, dtype, numel, how in PREPARED:
        for s in ("s1", "s2"):
            layers = prepare(params[0][s])
            x = torch.zeros((4, layers[0]["w"].shape[0]))
            fused_subnet._check(x, layers)
            fused_subnet._check_packed(x, layers, dtype, numel, how)


def test_load_deploy_returns_row_major_tensors_from_a_column_major_file(tmp_path):
    rng = np.random.default_rng(0)
    w = np.asfortranarray(rng.normal(size=(6, 4)).astype(np.float16))
    b = rng.normal(size=(4,)).astype(np.float16)
    path = os.path.join(tmp_path, "tiny.npz")
    np.savez(path, __header__=np.frombuffer(b"{}", dtype=np.uint8),
             **{"0/s1/0/w": w, "0/s1/0/b": b, "0/s2/0/w": w, "0/s2/0/b": b})
    shapes = ({s: [{"w": (6, 4), "b": (4,)}] for s in ("s1", "s2")},)
    params, header = load_deploy(path, shapes, device="cpu")
    assert header == {}
    for s in ("s1", "s2"):
        assert params[0][s][0]["w"].is_contiguous()
        np.testing.assert_array_equal(params[0][s][0]["w"].numpy(), w.astype(np.float32))


@pytest.mark.parametrize("prepare", [p[0] for p in PREPARED], ids=[p[3] for p in PREPARED])
def test_prepared_subnet_is_contiguous_from_transposed_views(prepare):
    rng = np.random.default_rng(1)
    dims = (10, 64, 64, 8)
    layers = [{"w": torch.from_numpy(rng.normal(size=(dims[i + 1], dims[i])).astype(np.float32)).t(),
               "b": torch.from_numpy(rng.normal(size=(2 * dims[i + 1],)).astype(np.float32))[::2]}
              for i in range(3)]
    assert not layers[0]["w"].is_contiguous() and not layers[0]["b"].is_contiguous()
    prepared = prepare(layers)
    x = torch.zeros((4, 10))
    fused_subnet._check(x, prepared)
    for layer, prep in zip(layers, prepared):
        assert torch.equal(prep["w"], layer["w"]) and torch.equal(prep["b"], layer["b"])
