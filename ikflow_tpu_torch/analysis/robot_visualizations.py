"""Robot solution-family renders and latent-distribution error statistics.

Port of ``analysis/robot_visualizations.py`` (the reference's
``notebooks/robot_visualizations.ipynb``, which (a) renders a robot with N
IKFlow solutions overlaid at a target pose in a Klampt OpenGL window, and
(b) per its overview cell "illustrates the impact of the latent noise
distribution on the resulting error statistics of generated samples"). This
headless analog:

1. renders a static solution-family figure (N skeleton overlays at the demo
   target pose) per robot to PNG: needs matplotlib, and raises its
   ImportError where it is missing;
2. prints a markdown table of pose-error statistics over a (distribution in
   {gaussian, uniform}) x (latent scale) sweep: needs only torch.

Run: python -m ikflow_tpu_torch.analysis.robot_visualizations [--model_name ...] [--robots ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Tuple

import torch

CELLS = [(d, s) for d in ("gaussian", "uniform") for s in (0.25, 0.5, 0.75, 1.0, 1.5)]


def render_solution_family(solver, n_solutions: int, out_path: str, seed: int = 0) -> str:
    """N solutions at the robot's demo target pose, overlaid as 3-D skeletons
    (the notebook's SOL_MODE="IKFLOW", N_SOLUTIONS=10 scene, headless)."""
    from ikflow_tpu_torch.visualization import _pyplot, _setup_ax, demo_target_pose, skeleton_points

    plt, _ = _pyplot()
    robot = solver.robot
    target = demo_target_pose(robot.name)
    sols = solver.generate_ik_solutions(target, n=n_solutions, allow_uninitialized=True,
                                        generator=torch.Generator(device=solver.device).manual_seed(seed))
    pts = skeleton_points(robot, sols).cpu().numpy()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    _setup_ax(ax, f"{robot.name} — {n_solutions} IK solutions")
    for p in pts:
        ax.plot(p[:, 0], p[:, 1], p[:, 2], "-o", markersize=3, alpha=0.6)
    ax.scatter(*target[:3], color="red", s=80, marker="*")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def latent_distribution_stats(solver, n_poses: int, n_sols: int, seed: int = 0,
                              targets: Optional[torch.Tensor] = None,
                              latents: Optional[Sequence[torch.Tensor]] = None) -> List[Tuple[str, float, float, float]]:
    """Error stats per (distribution, scale) of ``CELLS``: the notebook's
    overview claim. ``targets`` ((n_poses, 7)) and ``latents`` (one
    (n_poses * n_sols, D) draw per cell, already scaled) replace the draws
    from ``seed``. -> rows of (distribution, scale, mean mm, mean deg)."""
    from ikflow_tpu_torch.lm import config_pose_errors

    robot = solver.robot
    g = torch.Generator(device=solver.device).manual_seed(seed)
    if targets is None:
        targets = robot.forward_kinematics(robot.sample_joint_angles(n_poses, g, joint_limit_eps=0.02))
    tiled = solver._tensor(targets).repeat_interleave(n_sols, dim=0)
    rows = []
    for cell_idx, (dist, scale) in enumerate(CELLS):
        sols = solver.generate_ik_solutions(tiled, latent=None if latents is None else latents[cell_idx],
                                            latent_distribution=dist, latent_scale=scale, generator=g,
                                            allow_uninitialized=True)
        pos_err, rot_err = config_pose_errors(robot, sols, tiled)
        rows.append((dist, scale, 1000.0 * float(pos_err.mean()), float(torch.rad2deg(rot_err.mean()))))
    return rows


def main(argv=None) -> int:
    from ikflow_tpu_torch.cli.common import add_device_argument

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model_name", type=str, default=None,
                        help="registry model (weights required unless --uninitialized)")
    parser.add_argument("--robots", type=str, nargs="*", default=["panda"],
                        help="robots to render when no --model_name is given")
    parser.add_argument("--n_solutions", type=int, default=10)
    parser.add_argument("--n_poses", type=int, default=100)
    parser.add_argument("--n_sols_per_pose", type=int, default=20)
    parser.add_argument("--out_dir", type=str, default="robot_visualizations")
    parser.add_argument("--uninitialized", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    solvers = []
    if args.model_name is not None:
        from ikflow_tpu_torch.registry import get_ik_solver

        solver, _ = get_ik_solver(args.model_name, allow_uninitialized=args.uninitialized, device=args.device)
        solvers.append(solver)
    else:
        from ikflow_tpu_torch.flow import FlowHyperParams
        from ikflow_tpu_torch.robots import get_robot
        from ikflow_tpu_torch.solver import IKFlowSolver

        for name in args.robots:
            robot = get_robot(name)
            hp = FlowHyperParams()
            hp.dim_latent_space = max(robot.ndof, 7)
            solvers.append(IKFlowSolver(hp, robot, seed=0, device=args.device))
    os.makedirs(args.out_dir, exist_ok=True)

    for solver in solvers:
        out = os.path.join(args.out_dir, f"{solver.robot.name}_solutions.png")
        print(f"rendering {out} ...", flush=True)
        render_solution_family(solver, args.n_solutions, out)

        print(f"\n### {solver.robot.name}: latent distribution vs error statistics "
              f"({args.n_poses} poses x {args.n_sols_per_pose} solutions)\n")
        print("| distribution | scale | mean pos err (mm) | mean rot err (deg) |")
        print("|---|---|---|---|")
        for dist, scale, mm, deg in latent_distribution_stats(solver, args.n_poses, args.n_sols_per_pose):
            print(f"| {dist} | {scale} | {mm:.3f} | {deg:.3f} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
