"""``ikflow-torch solve``: IK solutions for one pose from the command line.

Port of ``ikflow_tpu/cli/solve_cmd.py``, same flags and lines: the detailed
solutions (default), ``--exact`` solutions with their validity, or a
``--diverse`` farthest-point subset. ``--device`` (default ``cuda``) picks
the device.
"""

from __future__ import annotations

import argparse

from ikflow_tpu_torch.cli.common import add_device_argument, solver_from_args


def add_parser(sub):
    p = sub.add_parser("solve", help="sample IK solutions for a target pose")
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--robot_name", type=str, default=None)
    p.add_argument("--pose", type=float, nargs=7, required=True,
                   metavar=("X", "Y", "Z", "QW", "QX", "QY", "QZ"))
    p.add_argument("-n", "--n_solutions", type=int, default=10)
    p.add_argument("--exact", action="store_true")
    p.add_argument("--diverse", action="store_true",
                   help="maximize joint-space spread: draw n x --oversample candidates and keep the "
                        "farthest-point subset (solver.generate_diverse_ik_solutions)")
    p.add_argument("--oversample", type=int, default=4, help="candidate multiplier for --diverse")
    p.add_argument("--uninitialized", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    add_device_argument(p)
    p.set_defaults(func=run)
    return p


def run(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from ikflow_tpu_torch.evaluation import solution_diversity, solution_pose_errors

    solver, _ = solver_from_args(args)
    pose = solver._tensor(args.pose)
    g = torch.Generator(device=solver.device).manual_seed(args.seed)
    if args.exact:
        poses = pose.reshape(1, 7).expand(args.n_solutions, 7)
        sols, valids = solver.generate_exact_ik_solutions(poses, generator=g, allow_uninitialized=args.uninitialized)
        sols, valids = sols.cpu().numpy(), valids.cpu().numpy()
        for i in range(args.n_solutions):
            print(f"[{'ok' if bool(valids[i]) else 'FAIL'}] {sols[i].round(5)}")
    elif args.diverse:
        sols = solver.generate_diverse_ik_solutions(pose, n=args.n_solutions, oversample=args.oversample,
                                                    generator=g, allow_uninitialized=args.uninitialized)
        pos_e, rot_e = solution_pose_errors(solver.robot, sols, pose)
        div = float(solution_diversity(sols, 1, args.n_solutions)[0])
        sols, pos_e, rot_e = sols.cpu().numpy(), pos_e.cpu().numpy(), np.rad2deg(rot_e.cpu().numpy())
        for i in range(args.n_solutions):
            print(f"q={sols[i].round(5)}  pos_err={float(pos_e[i]) * 1000:.2f}mm rot_err={float(rot_e[i]):.2f}deg")
        print(f"mean pairwise spread: {div:.3f} rad over {args.n_solutions} solutions "
              f"(farthest-point subset of {args.n_solutions * args.oversample} candidates)")
    else:
        out = solver.generate_ik_solutions(pose, n=args.n_solutions, generator=g, return_detailed=True,
                                           allow_uninitialized=args.uninitialized)
        sols, pos_e, rot_e, jl, sc = (t.cpu().numpy() for t in out)
        rot_e = np.rad2deg(rot_e)
        for i in range(args.n_solutions):
            print(f"q={sols[i].round(5)}  pos_err={float(pos_e[i]) * 1000:.2f}mm "
                  f"rot_err={float(rot_e[i]):.2f}deg jlim={bool(jl[i])} selfcol={bool(sc[i])}")
    return 0
