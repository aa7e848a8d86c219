"""Multi-process smoke: a data-parallel training step and exact IK across
two processes of one ``torch.distributed`` group.

Port of ``analysis/multihost_smoke.py``. The launcher (the default mode)
starts two workers on this machine and checks their output. Each worker
joins the group through ``parallel.mesh.initialize_multihost`` at
``localhost:$IKFLOW_TPU_MH_PORT`` (default 29531), whose backend follows the
run's device, then:

1. takes one adamw step of the tiny flow (lr 1e-4) on a batch of 32 rows,
   its own 16 rows of it: the ranks gather each other's rows, every rank
   draws the step's noise over the whole batch from one seed, and the
   trainer's one-entry mesh runs the rank's rows and all-reduces the
   gradient, so both ranks end with the same parameters;
2. runs the exact solve (tiers (1, 2), 3 LM steps) of its 16 poses;
3. gathers the valid masks of all 32 poses.

``--device cuda`` (the default) puts rank i on ``cuda:i`` and joins over
NCCL; it needs a card per rank (NCCL refuses two ranks on one card) and
raises before starting a worker where there are fewer. ``--device cpu``
(the JAX script's own run, on virtual CPU devices) joins over gloo, also on
a machine with cards.

Launcher: python -m ikflow_tpu_torch.analysis.multihost_smoke [--device cpu]
Worker (internal): python -m ikflow_tpu_torch.analysis.multihost_smoke --worker <rank> --device <device>
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Tuple

import torch

N_PROC = 2
PER_PROC = 16
DEFAULT_PORT = 29531
WORKER_TIMEOUT_S = 600
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def port() -> int:
    return int(os.environ.get("IKFLOW_TPU_MH_PORT", str(DEFAULT_PORT)))


def worker_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank`` for a CUDA run (which needs
    ``N_PROC`` cards), else ``device``."""
    from ikflow_tpu_torch.config import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    if n < N_PROC:
        raise RuntimeError(f"--device cuda puts rank i on cuda:i and needs {N_PROC} cards; this machine has {n} "
                           "(NCCL refuses two ranks on one card); use --device cpu for the gloo run")
    return torch.device("cuda", rank)


def tiny_flow():
    """(flow, params): the tiny flow of panda (D = 8), weights from seed 0
    on the CPU, the same on every rank."""
    from ikflow_tpu_torch.flow import build_flow, tiny_model_params
    from ikflow_tpu_torch.robots import get_robot

    hp = tiny_model_params()
    hp.dim_latent_space = 8
    flow = build_flow(hp, get_robot("panda"))
    return flow, flow.init(torch.Generator().manual_seed(0))


def local_batch(robot, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s PER_PROC rows (q, poses), drawn on the CPU from seed
    100 + rank (joint_limit_eps 0.01)."""
    q = robot.sample_joint_angles(PER_PROC, torch.Generator().manual_seed(100 + rank), joint_limit_eps=0.01)
    return q, robot.forward_kinematics(q)


def step_noise(flow, robot, n: int):
    """The step's noise over the whole batch of ``n`` rows, from seed 7 on
    the CPU (every rank draws the same)."""
    from ikflow_tpu_torch.training.loss import make_loss_fn

    return make_loss_fn(flow, robot.ndof).draw(torch.zeros((n, robot.ndof)), torch.Generator().manual_seed(7))


def train_step(flow, robot, params, q: torch.Tensor, poses: torch.Tensor, noise, device, data_parallel: bool):
    """One adamw step on the batch (q, poses) with ``noise`` on ``device``.
    ``data_parallel``: on a one-entry mesh, so that under a process group
    each rank runs its share of the rows and the gradient is all-reduced.
    -> (the new parameters, detached, and the batch's loss)."""
    from ikflow_tpu_torch.parallel.mesh import make_mesh
    from ikflow_tpu_torch.training import TrainConfig, Trainer
    from ikflow_tpu_torch.training.common import tree_map

    cfg = TrainConfig(optimizer="adamw", learning_rate=1e-4, gamma=0.5, step_lr_every=1000, batch_size=q.shape[0])
    trainer = Trainer(flow, robot, cfg, device=device, mesh=make_mesh([device]) if data_parallel else None)
    params, optimizer, _ = trainer._start(params, None, 0)
    noise = tuple(None if t is None else t.to(device) for t in noise)
    loss = trainer._step(params, optimizer, q.to(device), poses.to(device), noise=noise, with_metrics=False)["tr/loss"]
    return tree_map(lambda t: t.detach(), params), float(loss)


def _gather(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def run_rank(rank: int, device):
    """Rank ``rank``'s run, its lines printed. -> (its parameters after the
    step, the batch's loss, the valid mask of all the ranks' poses)."""
    import torch.distributed as dist

    from ikflow_tpu_torch.parallel.mesh import initialize_multihost
    from ikflow_tpu_torch.robots import get_robot
    from ikflow_tpu_torch.solver import IKFlowSolver

    dev = worker_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_multihost(f"localhost:{port()}", N_PROC, rank, dev)
    try:
        robot = get_robot("panda")
        flow, params = tiny_flow()
        q_local, poses_local = local_batch(robot, rank)
        q, poses = _gather(q_local.to(dev)), _gather(poses_local.to(dev))
        n_global = q.shape[0]
        params, loss = train_step(flow, robot, params, q, poses, step_noise(flow, robot, n_global), dev, True)
        print(f"[p{rank}] train step ok, global loss={loss:.4f}", flush=True)

        solver = IKFlowSolver(flow.hp, robot, params=params, device=dev)
        _, valids = solver.generate_exact_ik_solutions(poses_local.to(dev), repeat_counts=(1, 2), n_opt_steps_max=3,
                                                       generator=torch.Generator(device=dev).manual_seed(8))
        valids_global = _gather(valids.to(torch.uint8))
        print(f"[p{rank}] exact-IK ok on {n_global} cross-process poses "
              f"({float(valids_global.float().mean()):.0%} valid)", flush=True)
    finally:
        dist.destroy_process_group()
    return params, loss, valids_global.bool()


def launcher(device="cuda") -> int:
    """Start the workers and check their lines."""
    for rank in range(N_PROC):
        worker_device(device, rank)  # refuse before starting a process
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = []
    for i in range(N_PROC):
        cmd = [sys.executable, "-m", "ikflow_tpu_torch.analysis.multihost_smoke", "--worker", str(i), "--device",
               str(device)]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    ok = True
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            lines = [line for line in out.splitlines() if line.startswith("[p")]
            print("\n".join(lines))
            if p.returncode != 0 or "exact-IK ok" not in out:
                ok = False
                print(f"worker {i} FAILED (rc={p.returncode}):\n{out[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("MULTIHOST SMOKE:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--worker", type=int, default=None, help="internal: run as this rank")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default: NCCL, rank i on cuda:i, a card per rank) or cpu (gloo)")
    args = parser.parse_args(argv)
    if args.worker is not None:
        run_rank(args.worker, args.device)
        return 0
    return launcher(args.device)


if __name__ == "__main__":
    raise SystemExit(main())
