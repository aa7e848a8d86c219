"""Tests of the CUDA kernels K1 (fp32 contract, 3xTF32 tensor cores) and K1'
(bf16 hidden layers) on the card. They skip where no CUDA device is present (decided inside each test);
run them on the card with

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ikflow_tpu_torch.flow import (
    fused_mlp,
    fused_mlp_bf16,
    fused_mlp_bf16_plain,
    fused_mlp_plain,
    prepare_bf16_subnet,
    prepare_tf32x3_subnet,
    tiny_model_params,
)
from ikflow_tpu_torch.flow.fused_subnet import LEAKY_SLOPE, split_tf32
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.solver import IKFlowSolver

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_mlp kernels have no CPU mode")
    return torch.device("cuda")


def _subnet(dims, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [
        {"w": (2 * torch.rand((dims[i], dims[i + 1]), generator=g, device=device) - 1) / dims[i] ** 0.5,
         "b": (2 * torch.rand((dims[i + 1],), generator=g, device=device) - 1) / dims[i] ** 0.5}
        for i in range(len(dims) - 1)
    ]


def _float64(x, layers):
    h = x.double()
    for i, layer in enumerate(layers):
        h = torch.addmm(layer["b"].double(), h, layer["w"].double())
        if i < len(layers) - 1:
            h = F.leaky_relu(h, LEAKY_SLOPE)
    return h


def _plain_tf32(x, layers):
    """K1's function with plain TF32 in the hidden layers (operands rounded
    to tf32, exact products, fp32 sums): what K1 must not be."""
    h, n = x, len(layers)
    for i, layer in enumerate(layers):
        if 0 < i < n - 1:
            h = split_tf32(h)[0] @ split_tf32(layer["w"])[0] + layer["b"]
        else:
            h = torch.addmm(layer["b"], h, layer["w"])
        if i < n - 1:
            h = F.leaky_relu(h, LEAKY_SLOPE)
    return h


# Ragged row counts around K1's 64-row tiles, and the serving path's; widths
# that are multiples of 128 (cluster sizes 1-8) and widths K1 zero-pads.
@pytest.mark.parametrize("B", [1, 15, 16, 17, 63, 64, 65, 127, 1000, 3000, 10000])
@pytest.mark.parametrize("dims", [
    (10, 1024, 1024, 1024, 8), (11, 1024, 1024, 1024, 6), (13, 256, 256, 10), (12, 128, 5),
    (16, 128, 128, 128, 128, 16), (64, 1024, 1024, 3), (10, 384, 384, 384, 8),
    (10, 320, 320, 8), (11, 1000, 1000, 1000, 6), (100, 200, 200, 16), (20, 36, 5),
])
def test_kernel_matches_plain(cuda, B, dims):
    layers = prepare_tf32x3_subnet(_subnet(dims, cuda, seed=B))
    x = torch.randn((B, dims[0]), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    before = fused_mlp.launches
    out = fused_mlp(x, layers)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    # fp32 sums over K <= 1024 in another order than cuBLAS
    torch.testing.assert_close(out, fused_mlp_plain(x, layers), atol=1e-4, rtol=1e-4)
    # The fp32 contract against float64, relative to the largest output: the
    # tolerance that plain TF32 fails (checked from 1000 rows, on the same
    # inputs), so a K1 that dropped a pass of 3xTF32 fails here.
    ref = _float64(x, layers)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((out.double() - ref).abs().max()) <= tol
    if len(dims) > 3 and B >= 1000:
        assert float((_plain_tf32(x, layers).double() - ref).abs().max()) > tol


# Every distinct subnet shape of the eight registered architectures (D = 7, 8
# or 10, softflow's conditional of 8 or the pose's 7), at the row counts the
# serving command line gives K1: one pose, 1000, evaluate's 25000 and the
# 250000 of its refinement's last tier.
@pytest.mark.parametrize("B", [1, 1000, 25000, 250000])
@pytest.mark.parametrize("io", [(10, 8), (11, 6), (11, 8), (12, 6), (12, 8), (13, 10)], ids=lambda io: f"{io[0]}to{io[1]}")
def test_kernel_matches_float64_at_model_shapes(cuda, B, io):
    dims = (io[0], 1024, 1024, 1024, io[1])
    layers = prepare_tf32x3_subnet(_subnet(dims, cuda, seed=io[0] * 100 + io[1]))
    x = torch.randn((B, dims[0]), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    before = fused_mlp.launches
    out = fused_mlp(x, layers)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1 and out.shape == (B, io[1])
    ref = _float64(x, layers)
    assert float((out.double() - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(out, fused_mlp_plain(x, layers), atol=1e-4, rtol=1e-4)


def test_kernel_refuses_what_it_does_not_take(cuda):
    layers = prepare_tf32x3_subnet(_subnet((10, 128, 128, 8), cuda, seed=0))
    with pytest.raises(ValueError):
        fused_mlp(torch.zeros((4, 20), device=cuda)[:, ::2], layers)
    with pytest.raises(TypeError):
        fused_mlp(torch.zeros((4, 10), device=cuda, dtype=torch.float64), layers)
    with pytest.raises(ValueError):
        fused_mlp(torch.zeros((4, 10), device=cuda), [{k: v.cpu() for k, v in lay.items()} for lay in layers])
    with pytest.raises(ValueError):  # width 66 is no multiple of 4
        fused_mlp(torch.zeros((4, 10), device=cuda), prepare_tf32x3_subnet(_subnet((10, 66, 8), cuda, seed=0)))
    with pytest.raises(ValueError):  # input wider than the hidden width
        fused_mlp(torch.zeros((4, 130), device=cuda), prepare_tf32x3_subnet(_subnet((130, 128, 128, 8), cuda, 0)))
    with pytest.raises(ValueError):  # hidden weights never packed
        fused_mlp(torch.zeros((4, 10), device=cuda), _subnet((10, 128, 128, 8), cuda, seed=0))


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


# K1' against its plain version on the card. Both round the same operands to
# bf16 and sum exact products in fp32, in another order (tensor-core k-steps
# vs cuBLAS), so an activation within an fp32 ulp of a bf16 rounding boundary
# may round the other way in a later layer: most outputs agree to 1e-5, all to
# BF16_LOOSE.
BF16_TIGHT, BF16_TIGHT_SHARE, BF16_LOOSE = 1e-5, 0.9, 2e-3


def assert_bf16_close(out, ref):
    err = (out - ref).abs()
    assert float(err.max()) <= BF16_LOOSE, f"max abs err {float(err.max())}"
    assert float((err <= BF16_TIGHT).float().mean()) >= BF16_TIGHT_SHARE


# Ragged row counts around K1''s 64-row tiles, and the serving path's; the
# shapes it had, widths that are multiples of 128 (cluster sizes 1-8) and
# widths it zero-pads, with an input of 100.
@pytest.mark.parametrize("B", [1, 63, 64, 65, 127, 128, 129, 1000, 3000, 10000])
@pytest.mark.parametrize("dims", [
    (10, 1024, 1024, 1024, 8), (11, 1024, 1024, 1024, 6), (13, 256, 256, 10), (12, 64, 5),
    (16, 128, 128, 128, 128, 16), (20, 48, 48, 48, 4), (64, 1024, 1024, 3), (10, 384, 384, 384, 8),
    (10, 512, 512, 8), (12, 640, 640, 640, 8), (10, 768, 768, 8), (10, 896, 896, 896, 8), (10, 320, 320, 8),
    (11, 1000, 1000, 1000, 6), (100, 200, 200, 16), (20, 36, 36, 5),
])
def test_bf16_kernel_matches_plain(cuda, B, dims):
    layers = prepare_bf16_subnet(_subnet(dims, cuda, seed=B + len(dims)))
    x = torch.randn((B, dims[0]), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    before, before_k1 = fused_mlp_bf16.launches, fused_mlp.launches
    out = fused_mlp_bf16(x, layers)
    torch.cuda.synchronize()
    assert fused_mlp_bf16.launches == before + 1 and fused_mlp.launches == before_k1
    ref = fused_mlp_bf16_plain(x, layers)
    assert bool(torch.isfinite(out).all())
    if len(dims) == 3:  # depth 1: no bf16 layer, K1's function in fp32
        torch.testing.assert_close(out, fused_mlp_plain(x, layers), atol=1e-4, rtol=1e-4)
    else:
        assert_bf16_close(out, ref)


def test_bf16_kernel_refuses_what_it_does_not_take(cuda):
    layers = prepare_bf16_subnet(_subnet((10, 64, 64, 8), cuda, seed=0))
    x = torch.zeros((4, 10), device=cuda)
    with pytest.raises(ValueError):
        fused_mlp_bf16(torch.zeros((4, 20), device=cuda)[:, ::2], layers)
    with pytest.raises(TypeError):
        fused_mlp_bf16(x.double(), layers)
    with pytest.raises(ValueError):  # hidden weights never packed
        fused_mlp_bf16(x, _subnet((10, 64, 64, 8), cuda, seed=0))
    with pytest.raises(ValueError):  # packed weights on the host
        fused_mlp_bf16(x, [dict(lay, wp=lay["wp"].cpu()) if "wp" in lay else lay for lay in layers])
    with pytest.raises(ValueError):  # width 66 is no multiple of 4
        fused_mlp_bf16(x, prepare_bf16_subnet(_subnet((10, 66, 66, 8), cuda, seed=0)))
    with pytest.raises(ValueError):  # input wider than the hidden width
        fused_mlp_bf16(torch.zeros((4, 130), device=cuda), prepare_bf16_subnet(_subnet((130, 128, 128, 8), cuda, 0)))


def test_bf16_flow_inverse_runs_the_bf16_kernel(cuda):
    hp = tiny_model_params()
    hp.dim_latent_space = 8
    hp.bf16_hidden = True
    solver = IKFlowSolver(hp, get_robot("panda"), device=cuda)
    poses = torch.randn((37, 7), device=cuda)
    latent = torch.randn((37, 8), device=cuda)
    before, before_k1 = fused_mlp_bf16.launches, fused_mlp.launches
    q_card = solver.generate_ik_solutions(poses, latent=latent, allow_uninitialized=True)
    assert fused_mlp_bf16.launches - before == 2 * hp.nb_nodes and fused_mlp.launches == before_k1
    cpu = IKFlowSolver(hp, get_robot("panda"), device="cpu",
                       params=[{s: [{k: v.cpu() for k, v in lay.items()} for lay in blk[s]] for s in blk}
                               for blk in solver.params])
    q_cpu = cpu.generate_ik_solutions(poses.cpu(), latent=latent.cpu(), allow_uninitialized=True)
    assert_bf16_close(q_card.cpu(), q_cpu)


def test_training_stays_on_the_card_and_validates_through_k1(cuda):
    """50 resident steps of a tiny flow: data, parameters and optimizer on the
    card, TF32 off, and the step-50 validation through K1 (2 x 3 launches).
    The training forward (plain subnets under autograd) on the card matches
    the CPU's within atol 1e-4 on z and 1e-4 x max(1, |logdet|) on logdet:
    fp32 sums of cuBLAS and of the CPU in another order."""
    from ikflow_tpu_torch.flow import build_flow
    from ikflow_tpu_torch.training import TrainConfig, Trainer, build_dataset_resident
    from ikflow_tpu_torch.training.common import tree_leaves, tree_map

    hp = tiny_model_params()
    hp.dim_latent_space, hp.sigmoid_on_output, hp.softflow_enabled = 8, True, False
    robot = get_robot("panda")
    flow = build_flow(hp, robot)
    params = flow.init(torch.Generator(device=cuda).manual_seed(0))
    ds = build_dataset_resident(robot, training_set_size=8192, test_set_size=64, device=cuda)
    assert ds.samples_tr.is_cuda and ds.endpoints_tr.is_cuda
    windows = []
    cfg = TrainConfig(n_steps=50, batch_size=256, log_every=10, eval_every=50, val_set_size=8, samples_per_pose=16,
                      learning_rate=1e-3)
    trainer = Trainer(flow, robot, cfg, metric_hook=lambda s, m: windows.append(m), device=cuda)
    before = fused_mlp.launches
    trained, metrics = trainer.fit_on_device(params, ds, steps_per_call=10)
    assert metrics["step"] == 50 and np.isfinite(metrics["tr/loss"])
    assert fused_mlp.launches - before == 2 * hp.nb_nodes
    losses = [m["tr/loss_window_mean"] for m in windows if "tr/loss_window_mean" in m]
    assert len(losses) == 5 and losses[-1] < losses[0]
    assert any("val/l2_error_mm" in m for m in windows)
    assert all(t.is_cuda for t in tree_leaves(trained))
    assert not torch.backends.cuda.matmul.allow_tf32
    x = torch.cat([ds.samples_tr[:64], torch.zeros((64, 1), device=cuda)], dim=1)
    cond = ds.endpoints_tr[:64]
    z, logdet = flow.forward(trained, x, cond)
    z_cpu, logdet_cpu = flow.forward(tree_map(lambda t: t.cpu(), trained), x.cpu(), cond.cpu())
    torch.testing.assert_close(z.cpu(), z_cpu, atol=1e-4, rtol=0)
    assert float((logdet.cpu() - logdet_cpu).abs().max()) <= 1e-4 * max(1.0, float(logdet_cpu.abs().max()))
