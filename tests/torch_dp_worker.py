"""One rank of the two-process data-parallel check in
``tests/test_torch_data_parallel.py``: joins a gloo process group through
``initialize_multihost`` (torchrun's environment markers, set by the test),
runs ``STEPS`` data-parallel steps of the tiny flow on a one-entry CPU mesh,
and saves the parameters and losses to ``argv[1]``. Importable: the test
runs the same steps in one process with ``run``."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from ikflow_tpu_torch.flow import build_flow, tiny_model_params  # noqa: E402
from ikflow_tpu_torch.parallel.mesh import initialize_multihost, make_mesh  # noqa: E402
from ikflow_tpu_torch.robots import get_robot  # noqa: E402
from ikflow_tpu_torch.training import TrainConfig, Trainer  # noqa: E402
from ikflow_tpu_torch.training.common import tree_leaves  # noqa: E402

BATCH, STEPS = 32, 2


def run(mesh_entries: int):
    """-> (parameter leaves, losses) after STEPS steps on a mesh of
    ``mesh_entries`` CPU entries, with the batch and noise from fixed seeds."""
    robot = get_robot("panda")
    hp = tiny_model_params()
    hp.dim_latent_space = 8
    flow = build_flow(hp, robot)
    params = flow.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    low, high = robot.limits_low().numpy(), robot.limits_high().numpy()
    q = torch.from_numpy((low + rng.uniform(size=(BATCH, 7)) * (high - low)).astype(np.float32))
    poses = robot.forward_kinematics(q)
    trainer = Trainer(flow, robot, TrainConfig(batch_size=BATCH), device="cpu",
                      mesh=make_mesh([torch.device("cpu")] * mesh_entries))
    params, optimizer, _ = trainer._start(params, None, 0)
    gen = torch.Generator().manual_seed(2)
    losses = [float(trainer._step(params, optimizer, q, poses, generator=gen)["tr/loss"]) for _ in range(STEPS)]
    return [t.detach().clone() for t in tree_leaves(params)], losses


if __name__ == "__main__":
    initialize_multihost()
    leaves, losses = run(1)
    torch.save({"leaves": leaves, "losses": losses, "rank": torch.distributed.get_rank()}, sys.argv[1])
    torch.distributed.destroy_process_group()
