"""The port's API walk-through (counterpart of ``examples/example.py``):
single-pose sampling with details, batched poses, exact solutions, and
diversity-maximizing sampling, on ``ikflow_tpu_torch``.

Quaternions are w, x, y, z.

Run:  python examples/torch_example.py [--model_name panda__full__lp191_5.25m]
          [--device cuda] [--uninitialized]
(random weights when the model has no trained artifact, or with
--uninitialized).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", type=str, default="panda__full__lp191_5.25m")
    parser.add_argument("--uninitialized", action="store_true", help="random weights")
    parser.add_argument("--device", type=str, default="cuda", help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    import torch

    from ikflow_tpu_torch.evaluation import solution_diversity
    from ikflow_tpu_torch.registry import get_ik_solver

    uninit = args.uninitialized
    try:
        ik_solver, _ = get_ik_solver(args.model_name, allow_uninitialized=uninit, device=args.device)
    except FileNotFoundError:
        print("(no trained weights found — running with random weights)")
        ik_solver, _ = get_ik_solver(args.model_name, allow_uninitialized=True, device=args.device)
        uninit = True
    robot, device = ik_solver.robot, ik_solver.device

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    # Single target pose, n solutions, with their errors.
    target_pose = torch.tensor([0.5, 0.5, 0.5, 1.0, 0.0, 0.0, 0.0])
    n = 5
    solutions, pos_errors, rot_errors, _, _ = ik_solver.generate_ik_solutions(
        target_pose, n=n, return_detailed=True, generator=gen(0), allow_uninitialized=uninit)
    print(f"\n{n} solutions for a single pose (robot: {robot.name}):")
    for i in range(n):
        print(f"  q={solutions[i].cpu().numpy().round(3)}  pos_err={1000 * float(pos_errors[i]):.2f} mm"
              f"  rot_err={float(torch.rad2deg(rot_errors[i])):.2f} deg")

    # Batched target poses.
    target_poses = robot.forward_kinematics(robot.sample_joint_angles(8, gen(1), joint_limit_eps=0.05))
    solutions = ik_solver.generate_ik_solutions(target_poses, generator=gen(0), allow_uninitialized=uninit)
    print(f"\nbatched: {solutions.shape[0]} solutions for {target_poses.shape[0]} poses")

    # Exact solutions: LM refinement of flow seeds over widening retry tiers.
    solutions, valids = ik_solver.generate_exact_ik_solutions(
        target_poses, generator=gen(2), allow_uninitialized=uninit, n_opt_steps_max=40 if uninit else 3)
    print(f"exact IK: {int(valids.sum())}/{valids.shape[0]} poses converged to 1 mm")

    # Diversity-maximizing sampling: a farthest-point subset of an oversampled draw.
    diverse = ik_solver.generate_diverse_ik_solutions(target_pose, n=n, oversample=8, generator=gen(3),
                                                      allow_uninitialized=uninit)
    plain = ik_solver.generate_ik_solutions(target_pose, n=n, generator=gen(3), allow_uninitialized=uninit)
    print(f"diverse sampling: mean pairwise spread {float(solution_diversity(diverse, 1, n)[0]):.3f} rad "
          f"(plain draw of the same size: {float(solution_diversity(plain, 1, n)[0]):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
