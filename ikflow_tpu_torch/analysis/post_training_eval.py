"""Post-training evaluation battery for a trained deploy artifact.

Port of ``analysis/post_training_eval.py``:
1. the accuracy protocol (500 poses x 50 solutions, latent scale 0.75,
   ``evaluate`` parity);
2. exact-IK validity and time at the benchmark tolerance (1 mm / 0.01 rad,
   tiers (1, 3, 10)) against the LM step budget (2, 3, 5);
3. capacity-capped retry tiers (1.0, 0.25, 0.0625) at 3 and 5 steps;
4. ``kernel_vs_plain_numerics`` (the JAX script's TPU-only
   ``pallas_vs_xla_numerics``), where the device is a card: the same
   latents through the trained flow's kernels (``GlowFlow.inverse``, K1 or
   K1') and its plain subnets (``GlowFlow.inverse_plain``), with the largest
   joint gap and each one's mean position error.

Each exact protocol is timed three times after ``graphs.WARMUP_CALLS``
untimed calls; it prints the median and the valid fraction of the first
timed call. ``--pallas`` is accepted for the JAX script's command lines and means
nothing here: on a card the flow always runs its kernels.

Usage: python -m ikflow_tpu_torch.analysis.post_training_eval --weights models/panda__full_sigmoid.npz
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

POS_TOL = 1e-3
ROT_TOL = 0.01
SAMPLES_PER_POSE = 50
LATENT_SCALE = 0.75
TIERS = (1, 3, 10)
CAPPED = (1.0, 0.25, 0.0625)
N_NUMERICS = 1024
ACCURACY_DIGITS = {"mean_l2_error_mm": 3, "mean_angular_error_deg": 3, "pct_joint_limits_exceeded": 2,
                   "pct_self_colliding": 2}


def load_solver(weights: str, device):
    """(solver, header) of a deploy artifact: the architecture from its
    header, its weights on ``device``."""
    from ikflow_tpu_torch.flow.model import build_flow
    from ikflow_tpu_torch.flow.params import FlowHyperParams
    from ikflow_tpu_torch.robots import get_robot
    from ikflow_tpu_torch.solver import IKFlowSolver
    from ikflow_tpu_torch.training.checkpoints import load_deploy, read_deploy_header

    header = read_deploy_header(weights)
    if header is None:
        raise ValueError(f"{weights} is not a deploy artifact (no readable header)")
    hp = FlowHyperParams.from_dict(header["hyper_parameters"])
    robot = get_robot(header["robot_name"])
    params, _ = load_deploy(weights, build_flow(hp, robot).param_shapes(), device)
    return IKFlowSolver(hp, robot, params=params, device=device), header


def study_poses(robot, n: int, generator: torch.Generator) -> torch.Tensor:
    return robot.forward_kinematics(robot.sample_joint_angles(n, generator, joint_limit_eps=0.02))


def accuracy(solver, testset: torch.Tensor, latent: torch.Tensor, m: int = SAMPLES_PER_POSE) -> Dict:
    """The accuracy protocol's JSON row, unrounded: ``testset`` (n, 7)
    poses, each ``m`` times, solved from ``latent`` ((n * m, D), already
    scaled)."""
    poses_t = testset.repeat_interleave(m, dim=0)
    sols = solver.generate_ik_solutions(poses_t, latent=latent)
    ev = solver.evaluate(poses_t, sols)
    return {
        "protocol": "accuracy_500x50_scale0.75",  # the protocol's name, whatever the counts
        "mean_l2_error_mm": 1000 * float(ev.pos_errors.mean()),
        "mean_angular_error_deg": float(torch.rad2deg(ev.rot_errors.mean())),
        "pct_joint_limits_exceeded": 100 * float(ev.joint_limits_exceeded.float().mean()),
        "pct_self_colliding": 100 * float(ev.self_colliding.float().mean()),
    }


def exact_protocol(solver, targets: torch.Tensor, tag: str, seed: int, **kw) -> Dict:
    """One exact protocol's JSON row: ``WARMUP_CALLS`` untimed solves, then
    three timed; the median time and the first timed call's valid
    fraction."""
    from ikflow_tpu_torch.analysis import warm_then_time

    ts, valids = warm_then_time(
        lambda i: solver.generate_exact_ik_solutions(
            targets, pos_error_threshold=POS_TOL, rot_error_threshold=ROT_TOL,
            generator=torch.Generator(device=solver.device).manual_seed(seed + i), **kw)[1],
        solver.device, 3)
    sec = sorted(ts)[1]
    return {"protocol": tag, "valid_fraction": round(float(valids[0].float().mean()), 4), "seconds": round(sec, 4),
            "sols_per_s": round(targets.shape[0] / sec, 1)}


def exact_protocols(solver, targets: torch.Tensor, seed: int = 10):
    """The five exact protocols, in the JAX script's order."""
    for steps in (2, 3, 5):
        yield exact_protocol(solver, targets, f"exact_steps{steps}_full", seed, repeat_counts=TIERS,
                             n_opt_steps_max=steps)
    for steps in (3, 5):
        yield exact_protocol(solver, targets, f"exact_steps{steps}_capped", seed, repeat_counts=TIERS,
                             n_opt_steps_max=steps, retry_capacities=CAPPED)


def kernel_vs_plain_numerics(solver, targets: torch.Tensor, latent: torch.Tensor) -> Dict:
    """The trained flow through its kernels and through its plain subnets on
    the same ``latent`` ((n, D)) at ``targets`` (n, 7): the largest joint
    gap, and each one's mean position error after the clamp."""
    from ikflow_tpu_torch.lm import config_pose_errors

    flow, robot, ndof = solver.flow, solver.robot, solver.robot.ndof
    cond = solver._conditional(targets)
    q_kernel = flow.inverse(solver._kernel_params, latent, cond)[0][:, :ndof]
    q_plain = flow.inverse_plain(solver.params, latent, cond)[0][:, :ndof]
    pe_plain, _ = config_pose_errors(robot, robot.clamp_to_joint_limits(q_plain), targets)
    pe_kernel, _ = config_pose_errors(robot, robot.clamp_to_joint_limits(q_kernel), targets)
    return {
        "protocol": "kernel_vs_plain_numerics",
        "max_abs_q_diff": float((q_plain - q_kernel).abs().max()),
        "mean_pos_err_mm_plain": round(1000 * float(pe_plain.mean()), 4),
        "mean_pos_err_mm_kernel": round(1000 * float(pe_kernel.mean()), 4),
    }


def main(argv=None) -> int:
    from ikflow_tpu_torch.analysis import RENAME_HELP
    from ikflow_tpu_torch.cli.common import add_device_argument
    from ikflow_tpu_torch.config import resolve_device

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
                                     epilog=f"JAX names: {RENAME_HELP}")
    parser.add_argument("--weights", type=str, required=True)
    parser.add_argument("--n_accuracy", type=int, default=500)
    parser.add_argument("--n_exact", type=int, default=1000)
    parser.add_argument("--pallas", action="store_true",
                        help="accepted for the JAX script's command lines; no effect: on a card the flow always "
                             "runs its kernels, on the CPU their plain versions")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    solver, header = load_solver(args.weights, device)
    robot = solver.robot
    print(f"loaded {args.weights}: robot={robot.name} step={header.get('global_step')}")

    g = torch.Generator(device=device).manual_seed(0)
    testset = study_poses(robot, args.n_accuracy, g)
    latent = LATENT_SCALE * torch.randn((args.n_accuracy * SAMPLES_PER_POSE, solver.network_width), generator=g,
                                        device=device)
    acc = accuracy(solver, testset, latent)
    print(json.dumps({k: round(v, ACCURACY_DIGITS[k]) if k in ACCURACY_DIGITS else v for k, v in acc.items()}),
          flush=True)

    targets = study_poses(robot, args.n_exact, g)
    for row in exact_protocols(solver, targets):
        print(json.dumps(row), flush=True)

    if device.type == "cuda":
        nv = min(N_NUMERICS, args.n_exact)
        z = torch.randn((nv, solver.network_width), generator=g, device=device)
        print(json.dumps(kernel_vs_plain_numerics(solver, targets[:nv], z)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
