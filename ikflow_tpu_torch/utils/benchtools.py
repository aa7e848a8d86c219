"""Chained solves for differenced timing. Port of
``ikflow_tpu/utils/benchtools.py``.

``build(iters)`` returns ``fn(i)``, which runs ``iters`` solves in a Python
loop. The poses of each solve take a value-neutral dependency on the
solutions before (``+ acc * 1e-30``), so no solve can start before the one
before it has finished, and ``fn`` reads the result once, at the end (the
exact solve's host tier skip also waits for the card once per tier).
``profiling.measure_per_iter_s`` differences two chain lengths. What both
lengths pay once cancels, but on a local card each iteration still holds the
host's time to launch one eager solve: where the solve is host-bound, that
time is what the difference measures.

The chains pass ``allow_uninitialized=True``: random weights do the same
work, so callers that report the rate state where the weights came from.
"""

from __future__ import annotations

import torch


def _generator(solver, seed: int, i: int) -> torch.Generator:
    return torch.Generator(device=solver.device).manual_seed(seed * 1_000_003 + i)


def chained_exact_build(
    solver,
    poses,
    seed: int = 0,
    repeat_counts=(1, 3, 10),
    pos_tol: float = 1e-3,
    rot_tol: float = 0.01,
    n_opt_steps_max: int = 3,
    latent_scale: float = 0.75,
    capacities=None,
):
    """``build(iters)`` for a chain of exact solves over ``poses``; pass it
    to ``profiling.measure_per_iter_s`` for seconds per solve."""
    poses = solver._tensor(poses)

    def build(iters):
        def run(i):
            g = _generator(solver, seed, i)
            acc = torch.zeros((), device=solver.device)
            for _ in range(iters):
                sols, _ = solver.generate_exact_ik_solutions(
                    poses + acc * 1e-30, repeat_counts=tuple(repeat_counts), pos_error_threshold=pos_tol,
                    rot_error_threshold=rot_tol, n_opt_steps_max=n_opt_steps_max, latent_scale=latent_scale,
                    generator=g, allow_uninitialized=True, retry_capacities=capacities,
                )
                acc = sols.sum() * 1e-6
            return float(acc)

        return run

    return build


def chained_approx_build(solver, poses, seed: int = 0, latent_scale: float = 1.0, scale_iters: int = 1):
    """``build(iters)`` for a chain of ``scale_iters * iters`` approximate
    solves (one flow inverse and the clamp each) over ``poses``; the caller
    divides the measured time per iteration by ``scale_iters``."""
    poses = solver._tensor(poses)

    def build(iters):
        def run(i):
            g = _generator(solver, seed, i)
            acc = torch.zeros((), device=solver.device)
            for _ in range(scale_iters * iters):
                sols = solver.generate_ik_solutions(poses + acc * 1e-30, latent_scale=latent_scale, generator=g,
                                                    allow_uninitialized=True)
                acc = sols.sum() * 1e-6
            return float(acc)

        return run

    return build
