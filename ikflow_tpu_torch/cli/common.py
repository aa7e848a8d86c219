"""What the serving subcommands share: the ``--device`` flag, the solver a
subcommand's flags name, and timing that waits for the card."""

from __future__ import annotations

import argparse
import time


def add_device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda", help="torch device (default cuda; cpu for tests)")


def solver_from_args(args: argparse.Namespace):
    """-> (solver, hyper_parameters) of ``--model_name``, or a solver of the
    default architecture with random weights for ``--robot_name`` (which sets
    ``args.uninitialized``), on ``--device``."""
    from ikflow_tpu_torch.flow import FlowHyperParams
    from ikflow_tpu_torch.registry import get_ik_solver
    from ikflow_tpu_torch.robots import get_robot
    from ikflow_tpu_torch.solver import IKFlowSolver

    if args.model_name:
        return get_ik_solver(args.model_name, allow_uninitialized=args.uninitialized, device=args.device)
    if not args.robot_name:
        raise SystemExit("need --model_name or --robot_name")
    args.uninitialized = True
    hp = FlowHyperParams()
    return IKFlowSolver(hp, get_robot(args.robot_name), device=args.device), hp


def timed_call_s(fn, device) -> float:
    """Wall seconds of one ``fn()``, the card's queue drained before and
    after (on a CUDA device, between CUDA events)."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3
