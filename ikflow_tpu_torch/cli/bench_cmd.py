"""``ikflow-torch benchmark``: runtime curves of approximate and exact IK.

Port of ``ikflow_tpu/cli/bench_cmd.py``, same flags and JSON rows on stdout:
``--mode approx|exact|both`` over ``--batch_sizes`` (exact IK at 1 mm / 0.01
rad, with ``--capacity probe|full``), ``--differencing``, ``--megabatch``
(a warm-up pass, then a cold leg that probes afresh and a warm leg from the
capacity cache), ``--sweep_nb_nodes`` and ``--compare`` (four solve methods,
the two native ones where the float64 oracle builds). ``--device`` (default
``cuda``) picks the device.

Per-call times are medians of ``--k`` calls, each timed with the card's
queue drained before and after. ``--differencing`` times chained solves
(``utils.benchtools``); on a card each solve in the chain still holds the
host's time to launch it. ``--scaling`` needs several GPUs, which are not
ported.
"""

from __future__ import annotations

import argparse
import json

from ikflow_tpu_torch.cli.common import add_device_argument, solver_from_args, timed_call_s

EXACT_POS_TOL = 1e-3
EXACT_ROT_TOL = 0.01
DIFFERENCED = "differencing, holds host launch time"  # each chained eager solve still pays its launches


def add_parser(sub):
    p = sub.add_parser("benchmark", help="runtime curves (approx + exact IK)")
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--robot_name", type=str, default="panda")
    p.add_argument("--batch_sizes", type=int, nargs="*", default=[1, 10, 100, 500, 1000, 5000])
    p.add_argument("--mode", choices=["approx", "exact", "both"], default="both")
    p.add_argument("--k", type=int, default=5, help="timed repeats per size")
    p.add_argument("--n_opt_steps_max", type=int, default=3)
    p.add_argument("--repeat_counts", type=int, nargs="*", default=[1, 3, 10])
    p.add_argument("--uninitialized", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sweep_nb_nodes", type=int, nargs="*", default=None,
                   help="runtime-vs-depth sweep of random-weight flows (100 solutions, 30 repeats)")
    p.add_argument("--scaling", action="store_true",
                   help="1-device vs all-devices exact-IK scaling efficiency (several GPUs: not ported)")
    p.add_argument("--megabatch", type=int, default=None,
                   help="streaming exact-IK over N poses in fixed-shape chunks (serving scale)")
    p.add_argument("--chunk_size", type=int, default=2048,
                   help="probe/tail chunk size for --megabatch")
    p.add_argument("--steady_chunk", type=int, default=32768, help="steady-state chunk size for --megabatch")
    p.add_argument("--compare", action="store_true",
                   help="4-method comparison: flow-approx / native-LM / flow+LM exact / native-LM seeded by flow")
    p.add_argument("--differencing", action="store_true",
                   help="time chained solves by differencing two chain lengths (refuses noise-dominated "
                        "measurements) instead of per-call timing. Applies to --mode approx/exact/both.")
    p.add_argument("--capacity", choices=["probe", "full", "compact"], default="probe",
                   help="retry-tier capacity policy for exact IK: 'probe' derives per-tier capacities from "
                        "a measured uncapped probe at each batch size (2x headroom over observed miss rates; "
                        "full width when tier-1 misses >40%%, e.g. untrained weights); 'full' re-solves "
                        "every pose in every tier; 'compact' (--megabatch only, its default) retries only "
                        "the measured misses via host-side cross-chunk compaction")
    add_device_argument(p)
    p.set_defaults(func=run)
    return p


def _timed(fn, k, device) -> float:
    """Median seconds of ``k`` calls of ``fn`` after one warm-up call, each
    call timed with the device's queue drained before and after."""
    fn()
    ts = sorted(timed_call_s(fn, device) for _ in range(k))
    return ts[len(ts) // 2]


def _poses(robot, n: int, g):
    return robot.forward_kinematics(robot.sample_joint_angles(n, g, joint_limit_eps=0.02))


def _run_compare(args, solver) -> int:
    """Four solve methods over the batch sizes: flow-approx (device), native
    LM from random seeds (host, float64), flow+LM exact (device), native LM
    seeded by the flow."""
    import numpy as np

    from ikflow_tpu_torch.robots.native_oracle import NativeFkOracle, native_available
    from ikflow_tpu_torch.training.common import generator

    robot, device = solver.robot, solver.device
    oracle = NativeFkOracle(robot) if native_available() else None
    for n in args.batch_sizes:
        poses = _poses(robot, n, generator(device, args.seed, n, 0))
        poses_np = poses.double().cpu().numpy()

        def m_approx():
            return solver.generate_ik_solutions(poses, generator=generator(device, args.seed, n, 1),
                                                allow_uninitialized=args.uninitialized)

        t = _timed(m_approx, args.k, device)
        print(json.dumps({"mode": "flow_approx", "batch": n, "seconds": t, "sols_per_s": n / t}))

        def m_exact():
            return solver.generate_exact_ik_solutions(
                poses, repeat_counts=tuple(args.repeat_counts), n_opt_steps_max=args.n_opt_steps_max,
                pos_error_threshold=EXACT_POS_TOL, rot_error_threshold=EXACT_ROT_TOL,
                generator=generator(device, args.seed, n, 1), allow_uninitialized=args.uninitialized,
            )[1]

        valids = m_exact()
        t = _timed(m_exact, args.k, device)
        print(json.dumps({"mode": "flow_plus_lm_exact", "batch": n, "seconds": t,
                          "sols_per_s": n / t, "valid_fraction": float(valids.float().mean())}))

        if oracle is not None:
            q_rand = robot.sample_joint_angles(n, generator(device, args.seed, n, 2)).double().cpu().numpy()

            def m_native():
                return oracle.ik_lm(poses_np, q_rand.copy(), max_iters=60, pos_tol=EXACT_POS_TOL,
                                    rot_tol=EXACT_ROT_TOL)

            _, valid = m_native()
            t = _timed(m_native, args.k, device)
            print(json.dumps({"mode": "native_lm_random_seed", "batch": n, "seconds": t,
                              "sols_per_s": n / t, "valid_fraction": float(valid.mean())}))

            seeds = np.asarray(m_approx().cpu(), dtype=np.float64)

            def m_native_seeded():
                return oracle.ik_lm(poses_np, seeds.copy(), max_iters=20, pos_tol=EXACT_POS_TOL,
                                    rot_tol=EXACT_ROT_TOL)

            _, valid = m_native_seeded()
            t = _timed(m_native_seeded, args.k, device)
            print(json.dumps({"mode": "native_lm_flow_seeded", "batch": n, "seconds": t,
                              "sols_per_s": n / t, "valid_fraction": float(valid.mean())}))
    return 0


def _run_sweep(args) -> int:
    """Runtime of 100 solutions against the flow's depth (random weights)."""
    import torch

    from ikflow_tpu_torch.flow import FlowHyperParams
    from ikflow_tpu_torch.robots import get_robot
    from ikflow_tpu_torch.solver import IKFlowSolver

    robot = get_robot(args.robot_name)
    for nb in args.sweep_nb_nodes or [4, 6, 8, 10, 12, 16]:
        hp = FlowHyperParams()
        hp.nb_nodes = nb
        hp.dim_latent_space = max(robot.ndof, 8)
        s = IKFlowSolver(hp, robot, device=args.device)
        pose = robot.forward_kinematics(robot.sample_joint_angles(1, torch.Generator(device=s.device).manual_seed(0)))[0]

        def go():
            s.generate_ik_solutions(pose, n=100, generator=torch.Generator(device=s.device).manual_seed(1),
                                    allow_uninitialized=True)

        t = _timed(go, 30, s.device)
        print(json.dumps({"mode": "nb_nodes_sweep", "nb_nodes": nb, "ms_per_100_sols": 1000 * t}))
    return 0


def _run_megabatch(args, solver) -> int:
    """Streaming exact IK over ``--megabatch`` reachable poses: a warm-up
    pass over the whole stream, then a cold leg (a fresh probe) and a warm
    leg (the cached capacities, no probe chunk)."""
    import time

    from ikflow_tpu_torch.parallel import fleet
    from ikflow_tpu_torch.training.common import generator
    from ikflow_tpu_torch.utils.profiling import synchronize

    poses = _poses(solver.robot, args.megabatch, generator(solver.device, args.seed, 0)).cpu().numpy()
    policy = {"probe": "probe", "compact": "compact", "full": None}[args.capacity]
    common = dict(chunk_size=args.chunk_size, steady_chunk=args.steady_chunk, retry_capacities=policy,
                  repeat_counts=tuple(args.repeat_counts), n_opt_steps_max=args.n_opt_steps_max,
                  pos_error_threshold=EXACT_POS_TOL, rot_error_threshold=EXACT_ROT_TOL,
                  allow_uninitialized=args.uninitialized, seed=args.seed)
    fleet.solve_exact_megabatch(solver, poses, **common)
    synchronize(solver.device)
    t0 = time.perf_counter()
    _, valids = fleet.solve_exact_megabatch(solver, poses, progress=True, capacity_cache=False, **common)
    sec = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, valids_warm = fleet.solve_exact_megabatch(solver, poses, capacity_cache=True, **common)
    sec_warm = time.perf_counter() - t0
    print(json.dumps({
        "mode": "exact_megabatch", "n": args.megabatch,
        "chunk_size": args.chunk_size, "steady_chunk": args.steady_chunk,
        "seconds": round(sec, 3), "sols_per_s": round(args.megabatch / sec, 1),
        "valid_fraction": round(float(valids.mean()), 4),
        "warm_seconds": round(sec_warm, 3),
        "warm_sols_per_s": round(args.megabatch / sec_warm, 1),
        "warm_valid_fraction": round(float(valids_warm.mean()), 4),
        "capacity": args.capacity,
    }))
    return 0


def run(args: argparse.Namespace) -> int:
    from ikflow_tpu_torch.solver import derive_retry_capacities
    from ikflow_tpu_torch.training.common import generator

    if args.scaling:
        raise NotImplementedError("--scaling needs several GPUs; multi-device serving is not ported yet "
                                  "(ROADMAP: multi-device serving and training over torch.distributed)")
    if args.sweep_nb_nodes is not None:
        return _run_sweep(args)
    solver, _ = solver_from_args(args)
    if args.compare:
        return _run_compare(args, solver)
    if args.megabatch:
        return _run_megabatch(args, solver)

    robot, device = solver.robot, solver.device

    def emit(row):
        print(json.dumps(row), flush=True)  # flushed: a cut sweep keeps its finished rows

    exact_kw = dict(repeat_counts=tuple(args.repeat_counts), pos_error_threshold=EXACT_POS_TOL,
                    rot_error_threshold=EXACT_ROT_TOL, n_opt_steps_max=args.n_opt_steps_max,
                    allow_uninitialized=args.uninitialized)
    for n in args.batch_sizes:
        poses = _poses(robot, n, generator(device, args.seed, n, 0))

        if args.mode in ("approx", "both"):
            if args.differencing:
                from ikflow_tpu_torch.utils.benchtools import chained_approx_build
                from ikflow_tpu_torch.utils.profiling import DegenerateTimingError, measure_per_iter_s

                build = chained_approx_build(solver, poses, args.seed, scale_iters=8)
                try:
                    t = measure_per_iter_s(build, f"approx n={n}", k_deltas=(20, 80)) / 8.0
                    emit({"mode": "approx", "batch": n, "seconds": t, "sols_per_s": n / t,
                          "methodology": DIFFERENCED})
                except DegenerateTimingError as e:
                    emit({"mode": "approx", "batch": n, "error": str(e)})
            else:
                def go_approx():
                    solver.generate_ik_solutions(poses, generator=generator(device, args.seed, n, 1),
                                                 allow_uninitialized=args.uninitialized)

                t = _timed(go_approx, args.k, device)
                emit({"mode": "approx", "batch": n, "seconds": t, "sols_per_s": n / t})

        if args.mode in ("exact", "both"):
            # The uncapped probe warms the path and measures the tier counts
            # that --capacity probe turns into retry capacities.
            _, probe_valids, tier_counts = solver.generate_exact_ik_solutions(
                poses, generator=generator(device, args.seed, n, 1), return_tier_counts=True, **exact_kw)
            uncapped_vf = float(probe_valids.float().mean())
            capacities = None
            if args.capacity == "probe":
                capacities = derive_retry_capacities(tier_counts.tolist(), n, len(args.repeat_counts))

            def go_exact():
                return solver.generate_exact_ik_solutions(
                    poses, generator=generator(device, args.seed, n, 1), retry_capacities=capacities,
                    **exact_kw)[1]

            valids = go_exact()
            row_common = {
                "valid_fraction": float(valids.float().mean()),
                "uncapped_valid_fraction": uncapped_vf,
                "capacity": list(capacities) if capacities else "full",
            }
            if args.differencing:
                from ikflow_tpu_torch.utils.benchtools import chained_exact_build
                from ikflow_tpu_torch.utils.profiling import DegenerateTimingError, measure_per_iter_s

                build = chained_exact_build(solver, poses, args.seed, repeat_counts=tuple(args.repeat_counts),
                                            pos_tol=EXACT_POS_TOL, rot_tol=EXACT_ROT_TOL,
                                            n_opt_steps_max=args.n_opt_steps_max, capacities=capacities)
                try:
                    t = measure_per_iter_s(build, f"exact n={n}", k_deltas=(20, 80))
                    emit({"mode": "exact", "batch": n, "seconds": t, "sols_per_s": n / t,
                          "methodology": DIFFERENCED, **row_common})
                except DegenerateTimingError as e:
                    emit({"mode": "exact", "batch": n, "error": str(e)})
            else:
                t = _timed(go_exact, args.k, device)
                emit({"mode": "exact", "batch": n, "seconds": t, "sols_per_s": n / t, **row_common})
    return 0
