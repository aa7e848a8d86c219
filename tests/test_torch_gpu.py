"""Tests of the CUDA kernel on the card. They skip where no CUDA device is
present (decided inside each test); run them on the card with

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from ikflow_tpu_torch.flow import fused_mlp, fused_mlp_plain, tiny_model_params
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.solver import IKFlowSolver

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_mlp kernel has no CPU mode")
    return torch.device("cuda")


def _subnet(dims, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [
        {"w": (2 * torch.rand((dims[i], dims[i + 1]), generator=g, device=device) - 1) / dims[i] ** 0.5,
         "b": (2 * torch.rand((dims[i + 1],), generator=g, device=device) - 1) / dims[i] ** 0.5}
        for i in range(len(dims) - 1)
    ]


@pytest.mark.parametrize("B", [1, 15, 16, 17, 1000, 10000])
@pytest.mark.parametrize("dims", [(10, 1024, 1024, 1024, 8), (11, 1024, 1024, 1024, 6), (13, 256, 256, 10)])
def test_kernel_matches_plain(cuda, B, dims):
    layers = _subnet(dims, cuda, seed=B)
    x = torch.randn((B, dims[0]), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    before = fused_mlp.launches
    out = fused_mlp(x, layers)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    # fp32 sums over K <= 1024 in another order than cuBLAS
    torch.testing.assert_close(out, fused_mlp_plain(x, layers), atol=1e-4, rtol=1e-4)


def test_kernel_refuses_what_it_does_not_take(cuda):
    layers = _subnet((10, 64, 8), cuda, seed=0)
    with pytest.raises(ValueError):
        fused_mlp(torch.zeros((4, 20), device=cuda)[:, ::2], layers)
    with pytest.raises(TypeError):
        fused_mlp(torch.zeros((4, 10), device=cuda, dtype=torch.float64), layers)
    with pytest.raises(ValueError):
        fused_mlp(torch.zeros((4, 10), device=cuda), [{k: v.cpu() for k, v in lay.items()} for lay in layers])


def test_flow_inverse_runs_the_kernel(cuda):
    hp = tiny_model_params()
    hp.dim_latent_space = 8
    solver = IKFlowSolver(hp, get_robot("panda"), device=cuda)
    poses = torch.randn((37, 7), device=cuda)
    before = fused_mlp.launches
    q = solver.generate_ik_solutions(poses, allow_uninitialized=True)
    assert fused_mlp.launches - before == 2 * hp.nb_nodes
    cpu = IKFlowSolver(hp, get_robot("panda"), device="cpu",
                       params=[{s: [{k: v.cpu() for k, v in lay.items()} for lay in blk[s]] for s in blk}
                               for blk in solver.params])
    latent = torch.randn((37, 8), device=cuda)
    q_card = solver.generate_ik_solutions(poses, latent=latent, allow_uninitialized=True)
    q_cpu = cpu.generate_ik_solutions(poses.cpu(), latent=latent.cpu(), allow_uninitialized=True)
    np.testing.assert_allclose(q_card.cpu().numpy(), q_cpu.numpy(), atol=1e-4)
    assert q.shape == (37, 7)
