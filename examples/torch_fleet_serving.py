"""Exact IK over several devices with the port (counterpart of
``examples/fleet_serving.py``):

1. ``solve_exact_sharded``: one batch, poses split over the mesh;
2. ``solve_exact_megabatch``: a large pose set streamed in fixed-shape
   chunks, here with the ``"probe"`` policy, which measures the retry tiers'
   miss rates on the first chunk and caps the retry tiers of every later
   chunk;
3. ``scaling_efficiency``: throughput on 1 device against the whole mesh.

The mesh is every CUDA device, or the list given with ``--devices`` (a
device may repeat: ``--devices cuda:0,cuda:0`` runs two replicas on one
card). Replicas that share a card, or the CPU, show the mechanics only: the
scaling rows then measure no cross-card scaling, and the script says so.

Run:  python examples/torch_fleet_serving.py [--devices cuda:0,cuda:0] [--uninitialized]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", type=str, default="panda__full__lp191_5.25m")
    parser.add_argument("--n", type=int, default=2048, help="poses for the sharded solve")
    parser.add_argument("--mega_n", type=int, default=0, help="poses for the streaming megabatch (0 = 4 chunks)")
    parser.add_argument("--chunk_size", type=int, default=1024)
    parser.add_argument("--uninitialized", action="store_true", help="random weights (the mechanics only)")
    parser.add_argument("--device", type=str, default="cuda", help="the solver's device (default cuda)")
    parser.add_argument("--devices", type=str, default=None,
                        help="comma-separated mesh devices (default: every CUDA device; with --device cpu, the CPU)")
    args = parser.parse_args(argv)

    import torch

    from ikflow_tpu_torch.parallel import make_mesh
    from ikflow_tpu_torch.parallel.fleet import scaling_efficiency, solve_exact_megabatch, solve_exact_sharded
    from ikflow_tpu_torch.registry import get_ik_solver

    solver, _ = get_ik_solver(args.model_name, allow_uninitialized=args.uninitialized, device=args.device)
    robot = solver.robot
    if args.devices:
        mesh = make_mesh(args.devices.split(","))
    else:
        mesh = make_mesh() if solver.device.type == "cuda" else make_mesh([solver.device])
    cards = {d for d in mesh.devices if d.type == "cuda"}
    print(f"mesh: {mesh.size} entries over axis {mesh.axis_names}: {[str(d) for d in mesh.devices]}")
    meaningful = len(cards) == mesh.size and mesh.size > 1

    g = torch.Generator(device=mesh.devices[0]).manual_seed(0)
    solve_kwargs = dict(repeat_counts=(1, 3, 10), n_opt_steps_max=3, pos_error_threshold=1e-3,
                        rot_error_threshold=0.01, allow_uninitialized=args.uninitialized)

    # 1. One batch split over the whole mesh.
    poses = robot.forward_kinematics(robot.sample_joint_angles(args.n, g, joint_limit_eps=0.02))
    _, valids = solve_exact_sharded(solver, poses, mesh=mesh, generator=g, **solve_kwargs)
    print(f"sharded solve: {args.n} poses -> {float(valids.float().mean()):.1%} valid")

    # 2. Streaming megabatch: device memory bounded by one chunk.
    mega_n = args.mega_n or 4 * args.chunk_size
    big = robot.forward_kinematics(robot.sample_joint_angles(mega_n, g, joint_limit_eps=0.02))
    _, valids = solve_exact_megabatch(solver, big.cpu().numpy(), chunk_size=args.chunk_size, mesh=mesh,
                                      retry_capacities="probe", progress=True, **solve_kwargs)
    print(f"megabatch: {mega_n} poses -> {valids.mean():.1%} valid")

    # 3. Throughput per device count.
    if not meaningful:
        print("scaling: the mesh has fewer distinct cards than entries (or one entry), so these rows show the "
              "mechanics, not scaling")
    for row in scaling_efficiency(solver, n_poses=args.n, devices=mesh.devices, generator=g, **solve_kwargs):
        print(f"  {row['devices']} device(s): {row['sols_per_s']:.0f} sols/s (efficiency {row['efficiency']:.0%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
