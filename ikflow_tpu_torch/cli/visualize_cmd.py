"""``ikflow-torch visualize``: the demo renders.

Port of ``ikflow_tpu/cli/visualize_cmd.py``, with the same flags plus
``--device`` (default ``cuda``): PNG/GIF renders through matplotlib
(``visualization``), or with ``--interactive`` one self-contained HTML scene
(``viz_interactive``), which needs nothing beyond numpy and torch.
"""

from __future__ import annotations

import argparse

from ikflow_tpu_torch.cli.common import add_device_argument, solver_from_args

DEMOS = ("oscillate_latent", "oscillate_target", "visualize_fk", "oscillate_joints")


def add_parser(sub):
    p = sub.add_parser("visualize", help="render demo visualizations (PNG/GIF, or HTML with --interactive)")
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--robot_name", type=str, default=None)
    p.add_argument("--demo_name", type=str, default="oscillate_latent", choices=DEMOS)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--n_frames", type=int, default=40)
    p.add_argument("--uninitialized", action="store_true")
    p.add_argument("--interactive", action="store_true",
                   help="write a self-contained interactive 3-D .html scene (orbit/zoom/scrub, no dependencies) "
                        "instead of PNG/GIF")
    add_device_argument(p)
    p.set_defaults(func=run)
    return p


def run(args: argparse.Namespace) -> int:
    solver, _ = solver_from_args(args)
    robot, device = solver.robot, solver.device
    if args.interactive:
        from ikflow_tpu_torch import viz_interactive as ivz

        out = args.output or f"{robot.name}__{args.demo_name}.html"
        if args.demo_name == "visualize_fk":
            path = ivz.interactive_fk(robot, out_path=out, device=device)
        elif args.demo_name == "oscillate_target":
            path = ivz.interactive_oscillate_target(solver, n_frames=args.n_frames, out_path=out,
                                                    allow_uninitialized=args.uninitialized)
        elif args.demo_name == "oscillate_joints":
            path = ivz.interactive_oscillate_joints(robot, n_frames=args.n_frames, out_path=out, device=device)
        else:
            path = ivz.interactive_oscillate_latent(solver, n_frames=args.n_frames, out_path=out,
                                                    allow_uninitialized=args.uninitialized)
        print(f"wrote {path}")
        return 0

    from ikflow_tpu_torch import visualization as viz

    ext = "png" if args.demo_name == "visualize_fk" else "gif"
    out = args.output or f"{robot.name}__{args.demo_name}.{ext}"
    if args.demo_name == "visualize_fk":
        path = viz.visualize_fk(robot, out_path=out, device=device)
    elif args.demo_name == "oscillate_latent":
        path = viz.oscillate_latent(solver, n_frames=args.n_frames, out_path=out)
    elif args.demo_name == "oscillate_target":
        path = viz.oscillate_target(solver, n_frames=args.n_frames, out_path=out)
    else:
        path = viz.oscillate_joints(robot, n_frames=args.n_frames, out_path=out, device=device)
    print(f"wrote {path}")
    return 0
