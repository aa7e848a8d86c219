"""Solution-refinement runtime comparison across solvers and batch sizes.

Port of ``analysis/solution_refinement_runtime.py`` (the reference's
``notebooks/solution_refinement_runtime_plotting.ipynb``, which times
IKFlow-seeded refinement by TRAC-IK and Klampt, C++ host solvers, across
batch sizes and pickles the results). The solvers:

- ``approx``: the flow inverse alone, no refinement (the floor);
- ``gpu_lm`` (the JAX script's ``tpu_lm``): the batched LM on the device,
  ``generate_exact_ik_solutions`` at its default tiers (1, 3, 10) and 3
  steps, the production path;
- ``native_lm``: the float64 C++ LM (``native/fk_oracle.cpp`` through
  ``robots.native_oracle.NativeFkOracle.ik_lm``, 10 iterations), seeded by
  the flow on the device, the copy of the seeds to the host inside the
  timed window; it plays the host solvers' role. Present where the oracle
  builds (g++).

Each (solver, batch size) cell is timed ``--k`` times after
``graphs.WARMUP_CALLS`` untimed calls; only the solve is inside the window,
the grading runs after it. Prints a markdown table and, with
``--out_pickle``, pickles per-solver ``runtimes``, ``stds`` and
``pct_success`` arrays, as the JAX script does.

Run: python -m ikflow_tpu_torch.analysis.solution_refinement_runtime [--model_name ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch

NATIVE_MAX_ITERS = 10


def study_targets(robot, n: int, generator: torch.Generator) -> torch.Tensor:
    """FK of ``n`` in-limit samples (joint_limit_eps 0.02)."""
    return robot.forward_kinematics(robot.sample_joint_angles(n, generator, joint_limit_eps=0.02))


def runtimes(solver, all_targets: torch.Tensor, batch_sizes: Sequence[int], pos_tol: float, rot_tol: float, k: int,
             oracle=None, model_name: Optional[str] = None) -> Dict:
    """The study's data: for each batch size n (the first n of
    ``all_targets``) and solver, the mean and spread of ``k`` timed solves
    and the success share of the last. ``oracle`` (a ``NativeFkOracle``)
    adds ``native_lm``.

    On a card, each batch size adds four keys to the solver's graph cache
    (the approximate sample and the three exact tiers): ten sizes come to 40,
    beyond ``graphs.DEFAULT_MAX_ENTRIES`` (32), so the cache evicts the
    earliest sizes' graphs, whose cells are done by then."""
    from ikflow_tpu_torch.analysis import warm_then_time
    from ikflow_tpu_torch.lm import config_pose_errors

    robot, device = solver.robot, solver.device
    names = ["approx", "gpu_lm"] + (["native_lm"] if oracle is not None else [])
    data = {"model_name": model_name or f"untrained:{robot.name}", "batch_sizes": list(batch_sizes),
            "pos_tol": pos_tol, "rot_tol": rot_tol}
    for s in names:
        data[s] = {key: np.zeros(len(batch_sizes)) for key in ("runtimes", "stds", "pct_success")}

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    for bi, n in enumerate(batch_sizes):
        targets = all_targets[:n]

        def solve_approx(i):
            return solver.generate_ik_solutions(targets, generator=generator(100 + i), allow_uninitialized=True)

        def grade_approx(sols):
            pos_err, rot_err = config_pose_errors(robot, sols, targets)
            return float(((pos_err < pos_tol) & (rot_err < rot_tol)).float().mean())

        def solve_gpu_lm(i):
            return solver.generate_exact_ik_solutions(targets, pos_error_threshold=pos_tol,
                                                      rot_error_threshold=rot_tol, generator=generator(200 + i),
                                                      allow_uninitialized=True)[1]

        def solve_native_lm(i):
            # The seeds are part of this method's cost (the notebook's
            # Klampt / TRAC-IK runs are IKFlow-seeded too), and so is their
            # copy to the host.
            seeds = solver.generate_ik_solutions(targets, generator=generator(300 + i), allow_uninitialized=True)
            _, valid = oracle.ik_lm(targets.double().cpu().numpy(), seeds.double().cpu().numpy(),
                                    max_iters=NATIVE_MAX_ITERS, pos_tol=pos_tol, rot_tol=rot_tol)
            return valid

        runners = {"approx": (solve_approx, grade_approx),
                   "gpu_lm": (solve_gpu_lm, lambda v: float(v.float().mean()))}
        if oracle is not None:
            runners["native_lm"] = (solve_native_lm, lambda v: float(v.mean()))
        for s, (solve_fn, grade_fn) in runners.items():
            ts, outs = warm_then_time(solve_fn, device, k)
            data[s]["runtimes"][bi] = float(np.mean(ts))
            data[s]["stds"][bi] = float(np.std(ts))
            data[s]["pct_success"][bi] = grade_fn(outs[-1])
    return data


def solver_names(data: Dict):
    return [s for s in ("approx", "gpu_lm", "native_lm") if s in data]


def print_table(data: Dict) -> None:
    names = solver_names(data)
    print(f"\n### Refinement runtime vs batch size ({data['model_name']}, "
          f"{data['pos_tol'] * 1000:.1f} mm / {np.degrees(data['rot_tol']):.3f} deg)\n")
    print("| n | " + " | ".join(f"{s} ms (success %)" for s in names) + " |")
    print("|---" * (len(names) + 1) + "|")
    for bi, n in enumerate(data["batch_sizes"]):
        cells = [f"{1000 * data[s]['runtimes'][bi]:.1f} ± {1000 * data[s]['stds'][bi]:.1f} "
                 f"({100 * data[s]['pct_success'][bi]:.0f}%)" for s in names]
        print(f"| {n} | " + " | ".join(cells) + " |")


def main(argv=None) -> int:
    from ikflow_tpu_torch.analysis import RENAME_HELP
    from ikflow_tpu_torch.cli.common import add_device_argument
    from ikflow_tpu_torch.robots.native_oracle import NativeFkOracle, native_available

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
                                     epilog=f"JAX names: {RENAME_HELP}")
    parser.add_argument("--model_name", type=str, default=None)
    parser.add_argument("--robot_name", type=str, default="panda")
    parser.add_argument("--batch_sizes", type=int, nargs="*",
                        default=[100, 200, 300, 400, 500, 600, 700, 800, 900, 1000])
    parser.add_argument("--pos_tol", type=float, default=1e-3)
    parser.add_argument("--rot_tol", type=float, default=0.01)
    parser.add_argument("--k", type=int, default=3, help="timing repeats per cell")
    parser.add_argument("--uninitialized", action="store_true")
    parser.add_argument("--out_pickle", type=str, default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    if args.model_name is not None:
        from ikflow_tpu_torch.registry import get_ik_solver

        solver, _ = get_ik_solver(args.model_name, allow_uninitialized=args.uninitialized, device=args.device)
    else:
        from ikflow_tpu_torch.flow import FlowHyperParams
        from ikflow_tpu_torch.robots import get_robot
        from ikflow_tpu_torch.solver import IKFlowSolver

        robot = get_robot(args.robot_name)
        hp = FlowHyperParams()
        hp.dim_latent_space = max(robot.ndof, 7)
        solver = IKFlowSolver(hp, robot, seed=0, device=args.device)

    oracle = NativeFkOracle(solver.robot) if native_available() else None
    all_targets = study_targets(solver.robot, max(args.batch_sizes),
                                torch.Generator(device=solver.device).manual_seed(7))
    data = runtimes(solver, all_targets, args.batch_sizes, args.pos_tol, args.rot_tol, args.k, oracle,
                    args.model_name)
    print_table(data)
    if args.out_pickle:
        with open(args.out_pickle, "wb") as f:
            pickle.dump(data, f)
        print(f"\nsaved {args.out_pickle}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
