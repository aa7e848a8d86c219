"""LM repeat-count / step-budget tuning analysis.

Port of ``analysis/lm_convergence_analysis.py`` (the reference's
``notebooks/ik_convergence_analysis.ipynb``, which tunes ``repeat_counts``
for ``generate_exact_ik_solutions``): sweeps (repeat_count, n_opt_steps) over
one tier at 1 mm / 0.01 rad and prints the valid fraction and the time of
one solve for each cell, as a markdown table. On a card each cell is one
captured tier graph (20 cells at the defaults, within the solver's
``graphs.DEFAULT_MAX_ENTRIES``), timed after ``graphs.WARMUP_CALLS``
untimed calls.

Run: python -m ikflow_tpu_torch.analysis.lm_convergence_analysis [--model_name ...] [--n 500] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Iterator, Sequence, Tuple

import torch

POS_TOL = 1e-3
ROT_TOL = 0.01


def study_poses(robot, n: int, generator: torch.Generator) -> torch.Tensor:
    """FK of ``n`` in-limit samples (joint_limit_eps 0.02), on the
    generator's device."""
    return robot.forward_kinematics(robot.sample_joint_angles(n, generator, joint_limit_eps=0.02))


def sweep(solver, poses, repeat_counts: Sequence[int], step_budgets: Sequence[int], generator: torch.Generator,
          allow_uninitialized: bool) -> Iterator[Tuple[int, int, float, float]]:
    """-> (repeat count, steps, valid fraction, seconds of the timed solve)
    per cell, the repeat count outermost; each cell is one tier of
    ``repeat_count`` over ``poses``."""
    from ikflow_tpu_torch.analysis import warm_then_time

    for r in repeat_counts:
        for steps in step_budgets:
            def go(i, r=r, steps=steps):
                return solver.generate_exact_ik_solutions(
                    poses, repeat_counts=(r,), n_opt_steps_max=steps, pos_error_threshold=POS_TOL,
                    rot_error_threshold=ROT_TOL, generator=generator, allow_uninitialized=allow_uninitialized,
                )[1]

            (seconds,), (valids,) = warm_then_time(go, solver.device)
            yield r, steps, float(valids.float().mean()), seconds


def main(argv=None) -> int:
    from ikflow_tpu_torch.cli.common import add_device_argument, solver_from_args

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model_name", type=str, default=None)
    parser.add_argument("--robot_name", type=str, default="panda")
    parser.add_argument("--n", type=int, default=500)
    parser.add_argument("--repeat_counts", type=int, nargs="*", default=[1, 2, 4, 8])
    parser.add_argument("--step_budgets", type=int, nargs="*", default=[2, 3, 5, 10, 20])
    parser.add_argument("--uninitialized", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    solver, _ = solver_from_args(args)
    poses = study_poses(solver.robot, args.n, torch.Generator(device=solver.device).manual_seed(1))
    generator = torch.Generator(device=solver.device).manual_seed(2)

    print(f"| repeat | steps | valid % | seconds (n={args.n}) |")
    print("|---|---|---|---|")
    for r, steps, valid, dt in sweep(solver, poses, args.repeat_counts, args.step_budgets, generator,
                                     args.uninitialized):
        print(f"| {r} | {steps} | {100 * valid:.1f} | {dt:.3f} |", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
