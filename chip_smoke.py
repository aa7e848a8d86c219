import faulthandler; faulthandler.dump_traceback_later(600, exit=True)  # noqa: E702  watchdog: a hang exits 1 with a traceback

# Smoke run of the PyTorch port on one NVIDIA GPU: build the CUDA kernels,
# hold each against its plain version, and drive the serving and training
# paths end to end.
#
#     python3 chip_smoke.py
#
# Runs from the root of a checkout with no install, network or git. Builds
# ``ikflow_tpu_torch/csrc/fused_mlp.cu`` (K1, the fp32 contract on the tensor
# cores) and ``fused_mlp_bf16.cu`` (K1', bf16 hidden layers) with one nvcc
# each, in parallel, into ``build/``, printing nvcc's -Xptxas -v report,
# loads ``panda__full__sigmoid`` (12 GLOW blocks, subnets 10/11 -> 1024 x 3 ->
# 8/6, fp32) from ``models/panda__full_sigmoid.npz``, and runs:
#
# 1. device: the card, its power limit and the TF32 flags;
# 2. kernel_vs_plain: K1 against addmm + leaky_relu on the shipped weights of
#    block 0 (atol/rtol 1e-4 and 99% of outputs within 1e-5, a contract that
#    plain TF32 is shown to fail), at the batch sizes the serving path gives
#    it, with its time against both bounds (fp32 SIMT, and its 3xTF32
#    tensor-core route) and,
#    at 1000 and 10000 rows, with cold L2 (calls rotating over all 24
#    subnets, as the solve does);
# 3. kernel_vs_plain_bf16: K1' against its plain bf16 version, the same way,
#    at K1's row counts, with K1's time on the same inputs beside it, and the
#    build's resources and occupancy of K1'; then on all 24 shipped subnets at
#    1000 and 10000 rows, its contract scaled by the size of each subnet's
#    outputs, beside both fp32 versions' gaps to the float64 sums;
# 4. self_collision: ``config_self_collides`` on 100000 uniform Panda samples
#    on the card against the CPU port on the same samples;
# 5. approx: ``generate_ik_solutions`` on 1000 poses (24 K1 launches), with
#    the 5-field detailed output;
# 6. exact: ``generate_exact_ik_solutions`` on 1000 reachable poses, tiers
#    (1, 3, 10), 3 LM steps, 1 mm / 0.01 rad, checked by an independent float64
#    forward kinematics;
# 7. profile: device time by kernel over a second, traced exact solve;
# 8. flow_vs_cpu: the card's flow against the plain flow on the CPU, 64 rows;
# 9. approx_bf16, exact_bf16, profile_bf16: the same through a solver built
#    with ``hp.bf16_hidden = True`` on the same weights (K1'); flow_vs_cpu_bf16
#    holds K1''s flow to the card's plain bf16 flow over 48 draws of 64 rows,
#    both against the CPU (the draws over 2e-2 and the median per-draw max);
# 10. megabatch, megabatch_bf16: 100000 reachable poses through
#     ``solve_exact_megabatch``, on the fp32 and on the bf16 solver;
# 11. diverse: ``generate_diverse_ik_solutions`` for one pose;
# 12. kernel_vs_plain_paths: K1 against addmm + leaky_relu at the row counts
#     the megabatch and diverse paths gave it, and K1' against its plain
#     version at the row counts the bf16 megabatch gave it;
# 13. dataset: ``build_dataset_resident`` with 2.5M train rows on the card,
#     every row inside the margined limits and free of self-collision, the
#     poses of 100000 rows against the card's FK and the float64 FK;
# 14. train_fresh: ``Trainer.fit_on_device`` of panda__full__sigmoid's
#     architecture at full width from ``flow.init`` (300 adamw steps of 512,
#     validated through K1), ms per step, steps/s, peak memory and a
#     torch.profiler split of one 100-step window; then 100 steps with
#     ``bf16_hidden`` (validated through K1');
# 15. train_warm: the ``train`` command in-process from the shipped weights
#     (200 steps at lr 1e-6, exported in fp16 through the registry's 13.0 mm
#     gate), the export graded against the shipped weights on the same poses
#     and latents, then served by ``get_ik_solver`` and solved exactly through
#     K1 on the 1000 poses of phase 6;
# 16. kernel_vs_plain_training: K1 and K1' against their plain versions at
#     the 12800 rows each validation gave them.
#
# Phases 13-15 write every file (cache, datasets, run directory, checkpoints,
# the export) under a temporary directory that is removed at the end.
#
# A kernel's ``ms`` (and ``plain_ms``, ``k1_ms``, ``cold_l2_ms``) is time per
# call with the calls launched one by one from Python between CUDA events, as
# every earlier version of this script measured it; under about 0.07 ms it is
# the host's launch overhead more than the kernel. ``graph_ms`` (and
# ``plain_graph_ms``, ``k1_graph_ms``, ``cold_l2_graph_ms``) is device time per
# call: the same calls captured in a CUDA graph and replayed.
#
# Every phase prints one JSON line; any failed check raises. The last line is
# ``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero and
# prints no result.

import concurrent.futures  # noqa: E402
import ctypes  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

MODEL = "panda__full__sigmoid"
N_POSES = 1000
KERNEL_ATOL = 1e-4  # fp32 sums over K = 1024 in another order than cuBLAS
KERNEL_RTOL = 1e-4
# K1's fp32 contract has a share condition too, because atol/rtol 1e-4 alone
# passes plain TF32 and passed a K1 whose tensor cores truncated its sums (max
# 2.2e-4, 89-93% of outputs within 1e-5 on the shipped weights). Sound fp32
# readings: 99.87-100%. The phase also shows that plain TF32 fails it.
KERNEL_FP32_TIGHT = 1e-5
KERNEL_FP32_TIGHT_SHARE = 0.99
FLOW_ATOL = 1e-3  # kernel flow on the card vs plain flow on the CPU, radians, after 24 subnets
# K1' vs its plain version: both round the same operands to bf16 and sum exact
# products in fp32, in another order, so an activation within an fp32 ulp of a
# bf16 rounding boundary can round the other way (one bf16 ulp) in the next
# layer, and every output of that row moves. The share condition is what tells
# the precision apart: most outputs agree to KERNEL_BF16_TIGHT (measured on the
# shipped weights: 97.0-97.7%, against 3.5-3.8% for the fp32 subnet from 1000
# rows up). All agree to _LOOSE, the measured maximum with margin (at most
# 5.8e-3, at 32768 rows; more rows draw more flips).
KERNEL_BF16_TIGHT = 1e-5
KERNEL_BF16_TIGHT_SHARE = 0.9
KERNEL_BF16_LOOSE = 1e-2
# The bf16 flow on the card vs the plain bf16 flow on the CPU, radians: such
# flips, in 2 x 1024 activations of each of 24 subnets, compound through the
# couplings' exp, so one draw's largest gap is not a property of the kernel
# (over 48 draws of 64 rows K1' passed 2e-2 on 39, the card's plain bf16 flow
# on 42, the earlier mma.sync K1' on 21). The bar holds K1''s flow to the
# card's plain bf16 flow over FLOW_BF16_DRAWS draws, both against the CPU:
# draws over FLOW_BF16_ATOL at most the plain flow's count plus
# FLOW_BF16_DRAW_MARGIN, and the median per-draw max within
# FLOW_BF16_MEDIAN_FACTOR of the plain flow's (measured: 9 / 6 draws, medians
# 5.8e-3 / 5.1e-3; the mma.sync K1' read 27 draws, median 2.5e-2, and fails
# both). The first draw's max and mean are printed beside it, against the
# one-draw bounds the bar replaces.
FLOW_BF16_ATOL = 2e-2
FLOW_BF16_MEAN_ATOL = 1e-3
FLOW_BF16_DRAWS = 48
FLOW_BF16_DRAW_MARGIN = 6
FLOW_BF16_MEDIAN_FACTOR = 2.0
N_MEGABATCH = 100000
FK_SLACK_POS = 1e-5  # float64 recheck of fp32 solutions: metres
FK_SLACK_ROT = 1e-4  # radians
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense bf16
# on the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
N_COLLISION = 100000
COLLISION_MAX_FLIPS = 10  # fp32 FK on the card and the CPU round differently near a contact
# Training. The dataset is ``train --dataset_size``'s default, cut from
# ``build_dataset_resident``'s 25M default; 15000 test rows, its default.
N_DATASET = 2_500_000
N_DATASET_TEST = 15_000
N_FK_CHECK = 100_000
FK_DATASET_POS = 1e-5  # metres: stored poses vs the float64 FK of their rows
FK_DATASET_ROT = 1e-4  # radians
TRAIN_STEPS, TRAIN_BATCH, TRAIN_WINDOW = 300, 512, 100
TRAIN_BF16_STEPS, TRAIN_BF16_WINDOW = 100, 50
WARM_STEPS = 200
WARM_VAL_RATIO = 0.10  # the exported weights' val l2 error within 10% of the shipped weights'
MATMUL_KERNEL = re.compile(r"gemm|cutlass|xmma|matmul|fused_mlp", re.IGNORECASE)


def emit(phase, t0, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3), **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps=20, rounds=20):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``rounds`` times between CUDA events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up on a side stream, as graph capture wants
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def ptxas_resources(log):
    """Registers, spills and stack of the one kernel in an nvcc -Xptxas -v log."""
    def grab(pattern):
        m = re.search(pattern, log)
        return int(m.group(1)) if m else None

    return {"registers": grab(r"Used (\d+) registers"), "spill_stores_bytes": grab(r"(\d+) bytes spill stores"),
            "spill_loads_bytes": grab(r"(\d+) bytes spill loads"), "stack_frame_bytes": grab(r"(\d+) bytes stack frame")}


def _bound(t_ops, t_bytes, flops):
    return {"bound_ms": 1e3 * max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops}


def subnet_bound(B, layers):
    """K1, two ways, each labeled: fp32 SIMT (every FLOP at the fp32 peak)
    and its route (the hidden layers as three TF32 passes at the TF32 peak,
    the first and last layer at the fp32 peak). Both move the function's
    bytes: x, out, biases and the 8.46 MB of fp32 weights, each once. (K1
    itself reads its hidden weights as packed hi/lo planes, twice their fp32
    bytes: a cost of its design, which the bound does not absorb.) The
    smaller is the kernel's bound."""
    hidden, edge = layers[1:-1], [layers[0], layers[-1]]
    flops_h = 2 * B * sum(lay["w"].shape[0] * lay["w"].shape[1] for lay in hidden)
    flops_e = 2 * B * sum(lay["w"].shape[0] * lay["w"].shape[1] for lay in edge)
    io_bytes = 4 * (B * layers[0]["w"].shape[0] + B * layers[-1]["w"].shape[1]
                    + sum(lay["b"].numel() for lay in layers))
    w_h = 4 * sum(lay["w"].numel() for lay in hidden)
    w_e = 4 * sum(lay["w"].numel() for lay in edge)
    simt = _bound((flops_h + flops_e) / PEAK_FP32_FLOPS, (io_bytes + w_h + w_e) / PEAK_BYTES_PER_S, flops_h + flops_e)
    route = _bound(3 * flops_h / PEAK_TF32_FLOPS + flops_e / PEAK_FP32_FLOPS,
                   (io_bytes + w_h + w_e) / PEAK_BYTES_PER_S, flops_h + flops_e)
    best = min((simt, route), key=lambda b: b["bound_ms"])
    return dict(best, simt_fp32_bound_ms=simt["bound_ms"], simt_fp32_bound_by=simt["bound_by"],
                tf32x3_bound_ms=route["bound_ms"], tf32x3_bound_by=route["bound_by"])


def subnet_bound_bf16(B, layers):
    """K1': the hidden layers' FLOP at the bf16 tensor-core peak plus the first
    and last layers' at the fp32 peak, against x, out, the fp32 first/last
    weights, the bf16 hidden weights and the biases, each moved once."""
    hidden = layers[1:-1]
    edge = [layers[0], layers[-1]]
    flops16 = 2 * B * sum(lay["w"].shape[0] * lay["w"].shape[1] for lay in hidden)
    flops32 = 2 * B * sum(lay["w"].shape[0] * lay["w"].shape[1] for lay in edge)
    nbytes = (4 * (B * layers[0]["w"].shape[0] + B * layers[-1]["w"].shape[1])
              + 4 * sum(lay["w"].numel() for lay in edge) + 2 * sum(lay["w"].numel() for lay in hidden)
              + 4 * sum(lay["b"].numel() for lay in layers))
    return _bound(flops16 / PEAK_BF16_FLOPS + flops32 / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S, flops16 + flops32)


def fk64(joints, q):
    """Independent float64 FK (numpy): q (n, ndof) -> (R (n, 3, 3), p (n, 3))."""
    n = q.shape[0]
    R = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    p = np.zeros((n, 3))
    qi = 0
    for j in joints:
        r, pi, y = j.rpy
        Rx = np.array([[1, 0, 0], [0, np.cos(r), -np.sin(r)], [0, np.sin(r), np.cos(r)]])
        Ry = np.array([[np.cos(pi), 0, np.sin(pi)], [0, 1, 0], [-np.sin(pi), 0, np.cos(pi)]])
        Rz = np.array([[np.cos(y), -np.sin(y), 0], [np.sin(y), np.cos(y), 0], [0, 0, 1]])
        p = p + R @ np.asarray(j.xyz, dtype=np.float64)
        R = R @ (Rz @ Ry @ Rx)
        a = np.asarray(j.axis, dtype=np.float64)
        if j.joint_type == "revolute":
            th = q[:, qi]
            K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
            Rj = np.eye(3) + np.sin(th)[:, None, None] * K + (1 - np.cos(th))[:, None, None] * (K @ K)
            R = R @ Rj
            qi += 1
        elif j.joint_type == "prismatic":
            p = p + q[:, qi, None] * (R @ a)
            qi += 1
    return R, p


def quat_to_matrix64(quat):
    w, x, y, z = quat.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)


def fk64_errors(robot, sols, targets):
    """Float64 recheck of (n, ndof) solutions against (n, 7) targets (numpy):
    -> (position errors [m], rotation errors [rad])."""
    R, p = fk64(robot.joints, sols)
    pos = np.linalg.norm(p - targets[:, :3], axis=-1)
    Rt = quat_to_matrix64(targets[:, 3:] / np.linalg.norm(targets[:, 3:], axis=-1, keepdims=True))
    cos = (np.einsum("nij,nij->n", Rt, R) - 1.0) / 2.0
    return pos, np.arccos(np.clip(cos, -1.0, 1.0))


def check_solutions(robot, sols, valids, targets, min_fraction, rot_tol):
    """The contract on host arrays: the valid share, every valid solution inside
    the limits and within 1 mm / ``rot_tol`` under float64 FK. -> summary."""
    v = np.asarray(valids)
    s = np.asarray(sols, dtype=np.float64)[v]
    t = np.asarray(targets, dtype=np.float64)[v]
    low = robot.limits_low().double().numpy()
    high = robot.limits_high().double().numpy()
    check(v.mean() >= min_fraction, f"only {v.sum()}/{v.size} poses solved")
    check(bool(((s >= low - 1e-6) & (s <= high + 1e-6)).all()), "a valid solution lies outside the joint limits")
    pos64, rot64 = fk64_errors(robot, s, t)
    check(float(pos64.max()) <= 1e-3 + FK_SLACK_POS, f"float64 FK recheck: max pos err {pos64.max()}")
    check(float(rot64.max()) <= rot_tol + FK_SLACK_ROT, f"float64 FK recheck: max rot err {rot64.max()}")
    return {"valid": int(v.sum()), "valid_fraction": float(v.mean()),
            "fk64_max_pos_err_mm": 1e3 * float(pos64.max()), "fk64_max_rot_err_deg": float(np.degrees(rot64.max()))}


def device_kernels(prof):
    """{kernel name: (device ms, launches)} of a finished torch.profiler run,
    summed over the raw trace's events: building the profiler's Python
    events (``events()``, ``key_averages()``) takes minutes over the ~160000
    kernels of a training window. User annotations on the device's timeline
    are not kernels and are left out."""
    kernels = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != torch.autograd.DeviceType.CUDA or evt.is_user_annotation():
            continue
        name = evt.name()
        ms, count = kernels.get(name, (0.0, 0))
        kernels[name] = (ms + evt.duration_ns() / 1e6, count + 1)
    return kernels


def profile_exact(solver, targets, g):
    """Device time by kernel over one exact solve, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(repeat_counts=(1, 3, 10), pos_error_threshold=1e-3, rot_error_threshold=0.01, n_opt_steps_max=3,
              generator=g)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.generate_exact_ik_solutions(targets, **kw)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    device_ms = sum(ms for ms, _ in kernels.values())
    k1_ms = sum(ms for k, (ms, _) in kernels.items() if "fused_mlp_kernel" in k)
    k1b_ms = sum(ms for k, (ms, _) in kernels.items() if "fused_mlp_bf16_kernel" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
        "kernel_launches": sum(c for _, c in kernels.values()),
        "fused_mlp_ms": k1_ms, "fused_mlp_share_of_device": k1_ms / device_ms,
        "fused_mlp_bf16_ms": k1b_ms, "fused_mlp_bf16_share_of_device": k1b_ms / device_ms,
        "top": [{"kernel": k[:80], "ms": ms, "count": c} for k, (ms, c) in top],
    }


def profile_split(fn, unprofiled_ms):
    """Device time of ``fn`` by kind from torch.profiler (device activity
    only, which keeps the trace small): matmul kernels (names matching
    MATMUL_KERNEL), the rest, and the idle share, of the profiled wall time
    and of ``unprofiled_ms``, the same work's time without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = device_kernels(prof)
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    device_ms = sum(ms for ms, _ in kernels.values())
    matmul_ms = sum(ms for k, (ms, _) in kernels.items() if MATMUL_KERNEL.search(k))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "unprofiled_ms": unprofiled_ms, "device_ms": device_ms, "matmul_ms": matmul_ms,
            "other_ms": device_ms - matmul_ms, "idle_share": 1.0 - device_ms / wall_ms,
            "idle_share_unprofiled": 1.0 - device_ms / unprofiled_ms,
            "matmul_share_unprofiled": matmul_ms / unprofiled_ms,
            "other_share_unprofiled": (device_ms - matmul_ms) / unprofiled_ms,
            "kernel_launches": sum(c for _, c in kernels.values()),
            "top": [{"kernel": k[:80], "ms": ms, "count": c} for k, (ms, c) in top]}


def phase_dataset(robot, dev):
    """``build_dataset_resident`` at N_DATASET rows on the card: every train
    row inside the margined limits and free of self-collision, the poses of
    N_FK_CHECK rows equal to the card's FK and to the float64 FK."""
    from ikflow_tpu_torch.training.dataset import DEFAULT_JOINT_LIMIT_EPS, build_dataset_resident

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ds = build_dataset_resident(robot, training_set_size=N_DATASET, test_set_size=N_DATASET_TEST,
                                only_non_self_colliding=True, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q, poses = ds.samples_tr, ds.endpoints_tr
    check(q.is_cuda and poses.is_cuda and tuple(q.shape) == (N_DATASET, robot.ndof) and tuple(poses.shape) ==
          (N_DATASET, 7), "the train split is not resident on the card at its size")
    check(ds.samples_te.shape == (N_DATASET_TEST, robot.ndof), "wrong test split")
    eps = DEFAULT_JOINT_LIMIT_EPS
    low, high = robot.limits_low(dev) + eps, robot.limits_high(dev) - eps
    outside = int((~((q >= low - 1e-6) & (q <= high + 1e-6)).all(dim=1)).sum())
    colliding = sum(int(robot.config_self_collides(q[i: i + 262144]).sum()) for i in range(0, N_DATASET, 262144))
    check(outside == 0, f"{outside} train rows outside the margined joint limits")
    check(colliding == 0, f"{colliding} train rows self-collide")
    fk_gap = float((robot.forward_kinematics(q[:N_FK_CHECK]) - poses[:N_FK_CHECK]).abs().max())
    pos64, rot64 = fk64_errors(robot, q[:N_FK_CHECK].double().cpu().numpy(), poses[:N_FK_CHECK].double().cpu().numpy())
    check(fk_gap <= FK_DATASET_POS, f"stored poses vs the card's FK: {fk_gap}")
    check(float(pos64.max()) <= FK_DATASET_POS and float(rot64.max()) <= FK_DATASET_ROT,
          f"stored poses vs float64 FK: {pos64.max()} m, {rot64.max()} rad")
    nbytes = q.numel() * q.element_size() + poses.numel() * poses.element_size()
    emit("dataset", t0, n_train=N_DATASET, n_test=N_DATASET_TEST, build_s=build_s, bytes_resident=nbytes,
         rows_outside_limits=outside, rows_self_colliding=colliding, fk_rows_checked=N_FK_CHECK,
         card_fk_max_abs_gap=fk_gap, fk64_max_pos_err_m=float(pos64.max()), fk64_max_rot_err_rad=float(rot64.max()),
         cut=f"training_set_size {N_DATASET} (build_dataset_resident's default: 25000000)")
    return ds


def _windows_hook(windows, events):
    """A metric hook that keeps each window's metrics and records a CUDA
    event at its end."""
    def hook(step, metrics):
        if "tr/loss_window_mean" in metrics:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        windows.append(metrics)
    return hook


def train_run(flow, robot, ds, dev, cfg, window, kernel, other):
    """``Trainer.fit_on_device`` from ``flow.init`` (seed 0) with the
    kernels' counts set to 0 just before: -> summary. Checks a finite loss,
    a last window mean below the first, and one validation through
    ``kernel`` (2 * nb_nodes launches) and none through ``other``."""
    from ikflow_tpu_torch.training import Trainer

    params = flow.init(torch.Generator(device=dev).manual_seed(0))
    windows, events = [], []
    trainer = Trainer(flow, robot, cfg, metric_hook=_windows_hook(windows, events), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    kernel.launches = 0
    other.launches = 0
    start.record()
    t0 = time.perf_counter()
    trained, metrics = trainer.fit_on_device(params, ds, steps_per_call=window)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    means = [m["tr/loss_window_mean"] for m in windows if "tr/loss_window_mean" in m]
    val = next(m for m in windows if "val/l2_error_mm" in m)
    ms = [a.elapsed_time(b) / window for a, b in zip([start] + events[:-1], events)]
    check(metrics["step"] == cfg.n_steps and len(means) == cfg.n_steps // window, f"ran {metrics['step']} steps")
    check(all(np.isfinite(means)) and np.isfinite(metrics["tr/loss"]), f"non-finite loss: {means}")
    check(means[-1] < means[0], f"the loss did not fall: window means {means}")
    check(kernel.launches == 2 * flow.hp.nb_nodes and other.launches == 0,
          f"validation ran its kernel {kernel.launches} times, the other {other.launches}")
    n_params = sum(t.numel() for blk in params for s in ("s1", "s2") for lay in blk[s] for t in lay.values())
    summary = {"steps": metrics["step"], "batch": cfg.batch_size, "params": n_params, "window_loss_means": means,
               "ms_per_step_windows": ms, "ms_per_step": float(np.median(ms)),
               "steps_per_s": 1e3 / float(np.median(ms)), "wall_s": wall_s,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(), "kernel_launches": kernel.launches,
               "validation": {k: v for k, v in val.items() if k.startswith("val")}}
    return trained, summary


def cold_l2_ms(kernel, params, B, gen, rounds=4):
    """Per-call time with the weights cold in L2: each round calls the kernel
    once on every subnet of ``params`` in turn (24 for panda__full__sigmoid,
    as one flow inverse does), so a call finds its weights evicted by the 23
    before it. -> (eager ms per call, graph ms per call, bytes of weights per
    round)."""
    dev = torch.device("cuda")
    subnets = [blk[s] for blk in params for s in ("s1", "s2")]
    xs = {}
    for layers in subnets:
        k = layers[0]["w"].shape[0]
        if k not in xs:
            xs[k] = torch.randn((B, k), generator=gen, device=dev)
    calls = [(xs[layers[0]["w"].shape[0]], layers) for layers in subnets]

    def one_round():
        for x, layers in calls:
            kernel(x, layers)

    nbytes = sum(t.numel() * t.element_size() for layers in subnets for lay in layers for t in lay.values())
    return (cuda_ms(one_round, rounds, warmup=1) / len(calls),
            graph_ms(one_round, reps=1, rounds=rounds) / len(calls), nbytes)


def kernel_rows(kernel, plain, bound, params, batches, gen, close, contrast=None, cold_batches=(),
                refuse_contrast_from=None, beside=None):
    """A kernel against its plain version on block 0's subnets of ``params``
    (``close(out, ref)`` lists the failures of its contract), and, where
    given, against a ``contrast`` function it must not match: -> (rows, max
    abs err, the B = 10000 s1 row). At ``cold_batches`` the s1 row also has
    the cold-L2 time over all of ``params``' subnets. From
    ``refuse_contrast_from`` rows up, the contrast itself must fail the
    contract against the plain version. ``beside`` = (name, kernel, params):
    another kernel timed on the same inputs, on its own copy of the
    subnets."""
    dev = torch.device("cuda")
    rows, max_err, headline = [], 0.0, None
    for B in batches:
        for sname in ("s1", "s2"):
            layers = params[0][sname]
            x = torch.randn((B, layers[0]["w"].shape[0]), generator=gen, device=dev)
            out_k = kernel(x, layers)
            torch.cuda.synchronize()
            out_p = plain(x, layers)
            err = (out_k - out_p).abs()
            check(bool(torch.isfinite(out_k).all()), f"non-finite kernel output at B={B} {sname}")
            fails = close(out_k, out_p)
            check(not fails, f"kernel disagrees with plain at B={B} {sname}: {fails}")
            iters = 20 if B >= 10000 else 50
            ms, g_ms = cuda_ms(lambda: kernel(x, layers), iters), graph_ms(lambda: kernel(x, layers))
            bounds = bound(B, layers)
            flops = bounds.pop("flops")
            row = {"B": B, "subnet": sname, "shape": [layers[0]["w"].shape[0], layers[-1]["w"].shape[1]],
                   "max_abs_err": float(err.max()), "share_within_1e-5": float((err <= 1e-5).float().mean()),
                   "ms": ms, "graph_ms": g_ms, "plain_ms": cuda_ms(lambda: plain(x, layers), iters),
                   "plain_graph_ms": graph_ms(lambda: plain(x, layers)), **bounds,
                   "kernel_tflops": flops / ms / 1e9, "roofline_share": bounds["bound_ms"] / ms,
                   "graph_roofline_share": bounds["bound_ms"] / g_ms}
            if beside is not None:
                name, other, other_params = beside
                row[f"{name}_ms"] = cuda_ms(lambda: other(x, other_params[0][sname]), iters)
                row[f"{name}_graph_ms"] = graph_ms(lambda: other(x, other_params[0][sname]))
            if B in cold_batches and sname == "s1":
                (row["cold_l2_ms"], row["cold_l2_graph_ms"],
                 row["cold_l2_weight_bytes_per_round"]) = cold_l2_ms(kernel, params, B, gen)
            if contrast is not None:
                out_c = contrast(x, layers)
                other = (out_k - out_c).abs()
                row["contrast_max_abs_err"] = float(other.max())
                row["contrast_share_within_1e-5"] = float((other <= 1e-5).float().mean())
                vs_plain = (out_c - out_p).abs()
                row["contrast_vs_plain_max_abs_err"] = float(vs_plain.max())
                row["contrast_vs_plain_share_within_1e-5"] = float((vs_plain <= 1e-5).float().mean())
                row["contrast_fails"] = close(out_c, out_p)  # the contract's conditions it fails
                if refuse_contrast_from is not None and B >= refuse_contrast_from:
                    check(bool(row["contrast_fails"]), f"the contrast meets the contract at B={B} {sname}")
            rows.append(row)
            max_err = max(max_err, row["max_abs_err"])
            if B == 10000 and sname == "s1":
                headline = row
    return rows, max_err, headline


def kernel_entry(name, specialization, source, launches, max_err, headline, training_launches):
    return {
        "name": name,
        "specialization": specialization,
        "route": "cuda",
        "source": source,
        "replaces": "ikflow_tpu/flow/pallas_subnet.py:97",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": None,
        "at": {"B": headline["B"], "subnet": headline["subnet"]},
        "training_launches": training_launches,
    }


def training_phases(hp, robot, targets, exact_kw, dev, tmp, shipped=os.path.join(ROOT, "models", "panda__full_sigmoid.npz")):
    """13. dataset, 14. train_fresh (fp32, its profile, then bf16), 15.
    train_warm (the train command from the shipped weights, its export
    served back through K1). Every file goes under ``tmp``. -> the kernels'
    launches in these phases."""
    from ikflow_tpu_torch import config
    from ikflow_tpu_torch.cli.main import main as cli_main
    from ikflow_tpu_torch.flow.fused_subnet import fused_mlp, fused_mlp_bf16
    from ikflow_tpu_torch.flow.model import build_flow
    from ikflow_tpu_torch.registry import get_ik_solver
    from ikflow_tpu_torch.training import TrainConfig, Trainer
    from ikflow_tpu_torch.training.checkpoints import load_deploy, read_deploy_header
    from ikflow_tpu_torch.training.common import tree_leaves

    config.CACHE_DIR = os.path.join(tmp, "cache")
    config.DATASET_DIR = os.path.join(config.CACHE_DIR, "datasets")
    config.MODELS_DIR = os.path.join(config.CACHE_DIR, "models")
    config.TRAINING_LOGS_DIR = os.path.join(config.CACHE_DIR, "training_logs")
    launches = {"fused_mlp": 0, "fused_mlp_bf16": 0}

    # 13. dataset
    ds = phase_dataset(robot, dev)

    # 14. train_fresh: full width from flow.init, adamw at lr 1e-4.
    t0 = time.perf_counter()
    flow = build_flow(hp, robot)
    cfg = TrainConfig(n_steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, learning_rate=1e-4, log_every=TRAIN_WINDOW,
                      eval_every=TRAIN_STEPS, checkpoint_every=0, seed=0)
    trained, fp32 = train_run(flow, robot, ds, dev, cfg, TRAIN_WINDOW, fused_mlp, fused_mlp_bf16)
    launches["fused_mlp"] += fp32["kernel_launches"]
    window_cfg = dataclasses.replace(cfg, n_steps=TRAIN_WINDOW, eval_every=0)
    split = profile_split(lambda: Trainer(flow, robot, window_cfg, device=dev).fit_on_device(
        trained, ds, steps_per_call=TRAIN_WINDOW), TRAIN_WINDOW * fp32["ms_per_step"])
    flow16 = build_flow(dataclasses.replace(hp, bf16_hidden=True), robot)
    cfg16 = dataclasses.replace(cfg, n_steps=TRAIN_BF16_STEPS, log_every=TRAIN_BF16_WINDOW,
                                eval_every=TRAIN_BF16_STEPS)
    _, bf16 = train_run(flow16, robot, ds, dev, cfg16, TRAIN_BF16_WINDOW, fused_mlp_bf16, fused_mlp)
    launches["fused_mlp_bf16"] += bf16["kernel_launches"]
    emit("train_fresh", t0, fp32=fp32, profile_window={"steps": TRAIN_WINDOW, **split}, bf16=bf16)

    # 15. train_warm: the train command in-process, from the shipped weights.
    t0 = time.perf_counter()
    export = os.path.join(tmp, "panda__full_sigmoid.npz")
    argv = ["train", "--robot_name", "panda", "--nb_nodes", str(hp.nb_nodes),
            "--dim_latent_space", str(hp.dim_latent_space), "--coeff_fn_config", str(hp.coeff_fn_config),
            "--coeff_fn_internal_size", str(hp.coeff_fn_internal_size), "--disable_softflow", "--sigmoid_on_output",
            "--init_npz", shipped, "--on_device_data", "--n_steps", str(WARM_STEPS), "--steps_per_call", "100",
            "--learning_rate", "1e-6", "--export", export, "--export_dtype", "float16",
            "--run_dir", os.path.join(tmp, "run_warm"), "--device", dev.type]
    fused_mlp.launches = 0
    fused_mlp_bf16.launches = 0
    t1 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t1
    cli_launches = fused_mlp.launches
    launches["fused_mlp"] += cli_launches
    header = read_deploy_header(export)
    check(rc == 0, f"train returned {rc}")
    check(header is not None and header["quality_gate_mm"] == 13.0 and header["stored_dtype"] == "float16"
          and header["quality"]["val_l2_error_mm"] <= 13.0, f"the export did not pass the 13.0 mm gate: {header}")
    check(header["warm_start"]["from"] == "panda__full_sigmoid.npz" and header["global_step"] == WARM_STEPS,
          f"export provenance: {header}")
    check(cli_launches == 2 * hp.nb_nodes and fused_mlp_bf16.launches == 0,
          f"the export's validation ran K1 {cli_launches} times, K1' {fused_mlp_bf16.launches} times")
    # Both weights graded by the port on the same poses and latents.
    grader = Trainer(flow, robot, TrainConfig(), device=dev)
    latents = torch.randn((grader.config.val_set_size * grader.config.samples_per_pose, hp.dim_latent_space),
                          generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    vals = {}
    fused_mlp.launches = 0
    for name, path in (("exported", export), ("shipped", shipped)):
        params, _ = load_deploy(path, flow.param_shapes(), dev)
        vals[name] = grader.validate(params, ds, latents=latents)["val/l2_error_mm"]
    launches["fused_mlp"] += fused_mlp.launches
    check(abs(vals["exported"] - vals["shipped"]) <= WARM_VAL_RATIO * vals["shipped"],
          f"val/l2_error_mm of the export {vals['exported']} vs the shipped weights {vals['shipped']}")
    # Served back: the registry finds the export first, and solves through K1.
    config.MODELS_DIR = tmp
    slv, _ = get_ik_solver(MODEL, device=dev)
    exported_params, _ = load_deploy(export, flow.param_shapes(), dev)
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(slv.params), tree_leaves(exported_params))),
          "get_ik_solver did not load the exported artifact")
    fused_mlp.launches = 0
    fused_mlp_bf16.launches = 0
    g = torch.Generator(device=dev).manual_seed(43)
    sols, valids, tier_counts = slv.generate_exact_ik_solutions(targets, generator=g, **exact_kw)
    torch.cuda.synchronize()
    tiers = [int(c) for c in tier_counts.cpu()]
    tiers_run = 1 + sum(1 for c in tiers[:-1] if c < N_POSES)
    check(fused_mlp.launches == 2 * hp.nb_nodes * tiers_run and fused_mlp_bf16.launches == 0,
          f"the exact solve ran K1 {fused_mlp.launches} times, K1' {fused_mlp_bf16.launches} times")
    launches["fused_mlp"] += fused_mlp.launches
    summary = check_solutions(robot, sols.cpu().numpy(), valids.cpu().numpy(), targets.cpu().numpy(), 0.99, 0.01)
    emit("train_warm", t0, steps=WARM_STEPS, cli_s=cli_s, export_bytes=os.path.getsize(export),
         export_quality=header["quality"], export_gate_mm=header["quality_gate_mm"],
         val_l2_error_mm=vals, val_ratio_bound=WARM_VAL_RATIO, exact=summary, tier_counts=tiers,
         kernel_launches=fused_mlp.launches, export_validation_launches=cli_launches)
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available; this script runs on the GPU only")

    from ikflow_tpu_torch import cuda_build
    from ikflow_tpu_torch.flow.fused_subnet import (
        LEAKY_SLOPE,
        fused_mlp,
        fused_mlp_bf16,
        fused_mlp_bf16_plain,
        fused_mlp_plain,
        split_tf32,
    )
    from ikflow_tpu_torch.flow.model import build_flow
    from ikflow_tpu_torch.parallel.fleet import solve_exact_megabatch
    from ikflow_tpu_torch.registry import get_ik_solver
    from ikflow_tpu_torch.solver import IKFlowSolver

    t_all = time.perf_counter()

    # Build: one nvcc per source, all started together, with their resource reports.
    t0 = time.perf_counter()
    names = ("fused_mlp", "fused_mlp_bf16")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        builds = dict(zip(names, pool.map(cuda_build.build, names)))
    for res in builds.values():
        print(res.log.strip(), flush=True)
    resources = {n: ptxas_resources(r.log) for n, r in builds.items()}
    emit("build", t0, libraries={n: os.path.relpath(r.path, ROOT) for n, r in builds.items()},
         nvcc_seconds={n: round(r.seconds, 3) for n, r in builds.items()}, resources=resources)

    # 1. device
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    solver, hp = get_ik_solver(MODEL, device="cuda")
    hp_bf16 = dataclasses.replace(hp, bf16_hidden=True)
    solver_bf16 = IKFlowSolver(hp_bf16, solver.robot, params=solver.params, device="cuda")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("device", t0, nvidia_smi=smi, name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, capability=list(torch.cuda.get_device_capability(0)),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32, cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         model=MODEL, blocks=hp.nb_nodes, width=hp.coeff_fn_internal_size)
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 must be off")

    # 2. K1 vs plain on the shipped weights of block 0.
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)

    def close_fp32(out_k, out_p):
        err = (out_k - out_p).abs()
        share = float((err <= KERNEL_FP32_TIGHT).float().mean())
        fails = [] if torch.allclose(out_k, out_p, atol=KERNEL_ATOL, rtol=KERNEL_RTOL) else [
            f"max abs err {float(err.max())} beyond atol/rtol {KERNEL_ATOL}"]
        if share < KERNEL_FP32_TIGHT_SHARE:
            fails.append(f"{share} of outputs within {KERNEL_FP32_TIGHT}, under {KERNEL_FP32_TIGHT_SHARE}")
        return fails

    def plain_tf32(x, layers):
        """K1's function with plain TF32 in the hidden layers (operands
        rounded to tf32, exact products, fp32 sums): what K1 must not be."""
        h, n = x, len(layers)
        for i, lay in enumerate(layers):
            if 0 < i < n - 1:
                h = split_tf32(h)[0] @ split_tf32(lay["w"])[0] + lay["b"]
            else:
                h = torch.addmm(lay["b"], h, lay["w"])
            if i < n - 1:
                h = torch.nn.functional.leaky_relu(h, LEAKY_SLOPE)
        return h

    # tiers 1-3 of 1000 poses, one pose; the kernel reads the solver's packed tf32 hi/lo planes
    rows, max_err, headline = kernel_rows(fused_mlp, fused_mlp_plain, subnet_bound, solver._kernel_params,
                                          (1000, 3000, 10000, 1), gen, close_fp32, contrast=plain_tf32,
                                          cold_batches=(1000, 10000), refuse_contrast_from=1000)
    n_clusters = ctypes.c_int(0)
    lib = cuda_build.load("fused_mlp")
    lib.ikflow_fused_mlp_max_active_clusters.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    check(lib.ikflow_fused_mlp_max_active_clusters(hp.coeff_fn_internal_size, ctypes.byref(n_clusters)) == 0,
          "cluster occupancy query failed")
    emit("kernel_vs_plain", t0, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, tight=KERNEL_FP32_TIGHT,
         tight_share=KERNEL_FP32_TIGHT_SHARE, contrast="plain TF32 (hidden operands rounded to tf32)",
         max_active_clusters=n_clusters.value, smem_bytes_per_cta=lib.ikflow_fused_mlp_smem_bytes(), rows=rows)

    # 3. K1' vs its plain version on the same weights, packed once by the bf16 solver.
    t0 = time.perf_counter()

    def close_bf16(out_k, out_p):
        err = (out_k - out_p).abs()
        share = float((err <= KERNEL_BF16_TIGHT).float().mean())
        fails = [] if float(err.max()) <= KERNEL_BF16_LOOSE else [f"max abs err {float(err.max())}"]
        if share < KERNEL_BF16_TIGHT_SHARE:
            fails.append(f"{share} of outputs within {KERNEL_BF16_TIGHT}, under {KERNEL_BF16_TIGHT_SHARE}")
        return fails

    # K1's row counts: the exact tiers' and the megabatch's, one pose and the diverse path's 128.
    rows_b, max_err_b, headline_b = kernel_rows(fused_mlp_bf16, fused_mlp_bf16_plain, subnet_bound_bf16,
                                                solver_bf16._kernel_params,
                                                (1, 128, 1000, 2048, 3000, 6144, 10000, 20480, 24576, 32768), gen,
                                                close_bf16, contrast=fused_mlp_plain, cold_batches=(1000, 10000),
                                                beside=("k1", fused_mlp, solver._kernel_params))
    def plain_bf16_f64(x, layers):
        """K1''s function with every sum in float64, where the products of
        bf16 operands are exact: the value both fp32 versions round."""
        h, n = x.double(), len(layers)
        for i, lay in enumerate(layers):
            w = lay["w"].to(torch.bfloat16) if 0 < i < n - 1 else lay["w"]
            h = (h.to(torch.bfloat16) if 0 < i < n - 1 else h).double() @ w.double() + lay["b"].double()
            if i < n - 1:
                h = torch.nn.functional.leaky_relu(h, LEAKY_SLOPE)
        return h

    def gap(out, ref, scale):
        err = (out - ref.float()).abs()
        return {"max_abs_err": float(err.max()), "share_within_1e-5": float((err <= KERNEL_BF16_TIGHT).float().mean()),
                "share_within_scaled": float((err <= KERNEL_BF16_TIGHT * scale).float().mean())}

    # K1' on every shipped subnet, held to its contract scaled by the size of
    # the subnet's outputs (they reach about 1100 in block 5, where an fp32 ulp
    # is 6e-5), with the kernel's and the plain version's gaps to the float64
    # sums beside it: a second witness that the gaps are rounding.
    every_subnet, gen_s = [], torch.Generator(device=dev).manual_seed(3)
    for B in (1000, 10000):
        for bi, blk in enumerate(solver_bf16._kernel_params):
            for sname in ("s1", "s2"):
                layers = blk[sname]
                x = torch.randn((B, layers[0]["w"].shape[0]), generator=gen_s, device=dev)
                out_k, out_p = fused_mlp_bf16(x, layers), fused_mlp_bf16_plain(x, layers)
                out_e = plain_bf16_f64(x, layers)
                scale = max(1.0, float(out_p.abs().max()))
                row = {"B": B, "block": bi, "subnet": sname, "out_abs_max": float(out_p.abs().max()),
                       **gap(out_k, out_p, scale), "kernel_vs_f64": gap(out_k, out_e, scale),
                       "plain_vs_f64": gap(out_p, out_e, scale)}
                check(bool(torch.isfinite(out_k).all()) and row["max_abs_err"] <= KERNEL_BF16_LOOSE * scale
                      and row["share_within_scaled"] >= KERNEL_BF16_TIGHT_SHARE,
                      f"K1' disagrees with plain beyond its scaled contract: {row}")
                every_subnet.append(row)
    lib_b = cuda_build.load("fused_mlp_bf16")
    ctas_b, clusters_b = ctypes.c_int(0), ctypes.c_int(0)
    lib_b.ikflow_fused_mlp_bf16_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                                      ctypes.POINTER(ctypes.c_int)]
    check(lib_b.ikflow_fused_mlp_bf16_occupancy(hp.coeff_fn_internal_size, ctypes.byref(ctas_b),
                                                ctypes.byref(clusters_b)) == 0, "K1' occupancy query failed")
    emit("kernel_vs_plain_bf16", t0, tight=KERNEL_BF16_TIGHT, tight_share=KERNEL_BF16_TIGHT_SHARE,
         loose=KERNEL_BF16_LOOSE, contrast="fused_mlp_plain (fp32)", build=resources["fused_mlp_bf16"],
         smem_bytes_per_cta=lib_b.ikflow_fused_mlp_bf16_smem_bytes(), ctas_per_sm=ctas_b.value,
         max_active_clusters=clusters_b.value, rows=rows_b, every_subnet=every_subnet)

    # 4. Self-collision on the card against the CPU port, on the same uniform samples.
    t0 = time.perf_counter()
    robot = solver.robot
    q_col = robot.sample_joint_angles(N_COLLISION, torch.Generator(device=dev).manual_seed(11))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    flags = robot.config_self_collides(q_col)
    torch.cuda.synchronize()
    col_s = time.perf_counter() - t1
    flags_cpu = robot.config_self_collides(q_col.cpu())
    flips = int((flags.cpu() != flags_cpu).sum())
    rate, rate_cpu = float(flags.float().mean()), float(flags_cpu.float().mean())
    check(flags.shape == (N_COLLISION,) and flags.is_cuda, "self-collision flags: wrong shape or device")
    check(flips <= COLLISION_MAX_FLIPS, f"card and CPU disagree on {flips} of {N_COLLISION} samples")
    check(0.0 < rate < 0.5, f"self-collision rate {rate} is implausible")
    emit("self_collision", t0, n=N_COLLISION, pairs=robot.n_capsule_pairs, rate=rate, rate_cpu=rate_cpu,
         disagreements=flips, max_disagreements=COLLISION_MAX_FLIPS, card_wall_s=col_s)

    # Targets: FK of in-limit samples, as the JAX package's contract draws them.
    g = torch.Generator(device=dev).manual_seed(42)
    q_gt = robot.sample_joint_angles(N_POSES, g, joint_limit_eps=0.02)
    targets = robot.forward_kinematics(q_gt)
    exact_kw = dict(repeat_counts=(1, 3, 10), pos_error_threshold=1e-3, rot_error_threshold=0.01,
                    n_opt_steps_max=3, return_tier_counts=True)

    def approx_and_exact(slv, phase, kernel, other):
        """The main path of one solver: approx then exact, with the kernels'
        counts set to 0 just before and read just after. -> (launches, tiers)."""
        kernel.launches = 0
        other.launches = 0
        t0 = time.perf_counter()
        sols, pos_err, rot_err, jle, colliding = slv.generate_ik_solutions(targets, generator=g,
                                                                            return_detailed=True)
        torch.cuda.synchronize()
        approx_s = time.perf_counter() - t0
        approx_launches = kernel.launches
        check(tuple(sols.shape) == (N_POSES, robot.ndof) and bool(torch.isfinite(sols).all()), "bad approx solutions")
        check(not bool(jle.any()), "approx solutions outside joint limits")
        check(colliding.shape == (N_POSES,) and colliding.dtype == torch.bool, "bad self-collision flags")
        check(approx_launches == 2 * hp.nb_nodes, f"expected {2 * hp.nb_nodes} launches, got {approx_launches}")
        emit(f"approx{phase}", t0, n=N_POSES, wall_s=approx_s, kernel_launches=approx_launches,
             mean_pos_err_mm=1e3 * float(pos_err.mean()), mean_rot_err_deg=float(torch.rad2deg(rot_err).mean()),
             self_colliding_share=float(colliding.float().mean()))

        t0 = time.perf_counter()
        sols, valids, tier_counts = slv.generate_exact_ik_solutions(targets, generator=g, **exact_kw)
        torch.cuda.synchronize()
        exact_s = time.perf_counter() - t0
        exact_launches = kernel.launches - approx_launches
        tiers = [int(c) for c in tier_counts.cpu()]
        tiers_run = 1 + sum(1 for c in tiers[:-1] if c < N_POSES)
        check(exact_launches == 2 * hp.nb_nodes * tiers_run,
              f"expected {2 * hp.nb_nodes * tiers_run} launches for {tiers_run} tiers, got {exact_launches}")
        check(other.launches == 0, f"the other kernel ran {other.launches} times on this path")
        summary = check_solutions(robot, sols.cpu().numpy(), valids.cpu().numpy(), targets.cpu().numpy(),
                                  0.99, 0.01)
        emit(f"exact{phase}", t0, n=N_POSES, **summary, tier_counts=tiers, tiers_run=tiers_run,
             kernel_launches=exact_launches, other_kernel_launches=other.launches, wall_s=exact_s,
             sols_per_s=N_POSES / exact_s)
        return kernel.launches, tiers

    params_cpu = [{k: [{n: t.cpu() for n, t in lay.items()} for lay in blk[k]] for k in blk}
                  for blk in solver.params]

    def flow_vs_cpu(slv, phase, atol):
        """The card's flow (kernel) vs the plain flow on the CPU, 64 rows."""
        t0 = time.perf_counter()
        latent = torch.randn((64, hp.dim_latent_space), generator=gen, device=dev)
        q_card, _ = slv.flow.inverse(slv._kernel_params, latent, targets[:64])
        q_cpu, _ = slv.flow.inverse(params_cpu, latent.cpu(), targets[:64].cpu())
        err = (q_card.cpu() - q_cpu).abs()
        check(float(err.max()) <= atol, f"card flow vs CPU flow: max abs err {float(err.max())} > {atol}")
        emit(f"flow_vs_cpu{phase}", t0, rows=64, max_abs_err=float(err.max()), mean_abs_err=float(err.mean()),
             atol=atol)

    def flow_vs_cpu_bf16(slv):
        """K1''s flow and the card's plain bf16 flow, each against the plain
        bf16 flow on the CPU, over FLOW_BF16_DRAWS draws of 64 rows (latents
        from seed 1000 + d, 64 of the targets); the one-draw reading (the
        draw this phase made before the bar) with the fp32 flow beside it."""
        t0 = time.perf_counter()
        plain_flow = build_flow(slv.flow.hp, robot)
        plain_flow._subnet_kernel = fused_mlp_bf16_plain  # the witness: plain sums on the card
        latent = torch.randn((64, hp.dim_latent_space), generator=gen, device=dev)
        q_card, _ = slv.flow.inverse(slv._kernel_params, latent, targets[:64])
        q_cpu, _ = slv.flow.inverse(params_cpu, latent.cpu(), targets[:64].cpu())
        q_fp32, _ = solver.flow.inverse(params_cpu, latent.cpu(), targets[:64].cpu())
        err, contrast = (q_card.cpu() - q_cpu).abs(), (q_card.cpu() - q_fp32).abs()
        one_draw = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()), "atol": FLOW_BF16_ATOL,
                    "mean_atol": FLOW_BF16_MEAN_ATOL, "contrast_fp32_flow_max_abs_err": float(contrast.max()),
                    "contrast_fp32_flow_mean_abs_err": float(contrast.mean())}
        maxes = {"kernel": [], "plain_card": []}
        for d in range(FLOW_BF16_DRAWS):
            z = torch.randn((64, hp.dim_latent_space), generator=torch.Generator(device=dev).manual_seed(1000 + d),
                            device=dev)
            cond = targets[64 * (d % 15): 64 * (d % 15) + 64]
            ref, _ = slv.flow.inverse(params_cpu, z.cpu(), cond.cpu())
            for name, (f, p) in (("kernel", (slv.flow, slv._kernel_params)), ("plain_card", (plain_flow, slv.params))):
                maxes[name].append(float((f.inverse(p, z, cond)[0].cpu() - ref).abs().max()))
        over = {k: sum(m > FLOW_BF16_ATOL for m in v) for k, v in maxes.items()}
        median = {k: float(np.median(v)) for k, v in maxes.items()}
        check(over["kernel"] <= over["plain_card"] + FLOW_BF16_DRAW_MARGIN,
              f"K1''s flow passes {FLOW_BF16_ATOL} on {FLOW_BF16_DRAWS - over['kernel']} of {FLOW_BF16_DRAWS} draws, "
              f"the plain flow on {FLOW_BF16_DRAWS - over['plain_card']}")
        check(median["kernel"] <= FLOW_BF16_MEDIAN_FACTOR * median["plain_card"],
              f"K1''s flow median per-draw max {median['kernel']} vs plain {median['plain_card']}")
        emit("flow_vs_cpu_bf16", t0, rows=64, draws=FLOW_BF16_DRAWS, atol=FLOW_BF16_ATOL,
             draw_margin=FLOW_BF16_DRAW_MARGIN, median_factor=FLOW_BF16_MEDIAN_FACTOR, draws_over_atol=over,
             median_draw_max_abs_err=median, max_abs_err={k: max(v) for k, v in maxes.items()}, one_draw=one_draw)

    # 5-8. The fp32 main path (K1), where the time goes, and the flow against the CPU.
    main_path_launches, tiers_fp32 = approx_and_exact(solver, "", fused_mlp, fused_mlp_bf16)
    t0 = time.perf_counter()
    emit("profile", t0, **profile_exact(solver, targets, g))
    flow_vs_cpu(solver, "", FLOW_ATOL)

    # 9. The bf16 main path (K1') on the same targets.
    main_path_launches_bf16, tiers_bf16 = approx_and_exact(solver_bf16, "_bf16", fused_mlp_bf16, fused_mlp)
    t0 = time.perf_counter()
    emit("profile_bf16", t0, tier_counts_fp32=tiers_fp32, tier_counts_bf16=tiers_bf16,
         **profile_exact(solver_bf16, targets, g))
    flow_vs_cpu_bf16(solver_bf16)

    # 10. megabatch: 100000 reachable poses streamed through the fp32 solver,
    # then through the bf16 solver (K1').
    q_mb = robot.sample_joint_angles(N_MEGABATCH, torch.Generator(device=dev).manual_seed(7), joint_limit_eps=0.02)
    targets_mb = robot.forward_kinematics(q_mb).cpu().numpy()

    def megabatch(slv, phase, kernel, other):
        t0 = time.perf_counter()
        kernel.launches = 0
        other.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sols_mb, valids_mb, stats = solve_exact_megabatch(
            slv, targets_mb, seed=0, pos_error_threshold=1e-3, rot_error_threshold=0.01, return_stats=True,
        )
        mb_s = time.perf_counter() - t1
        check(sols_mb.shape == (N_MEGABATCH, robot.ndof) and bool(np.isfinite(sols_mb).all()), "bad megabatch output")
        check(kernel.launches == 2 * hp.nb_nodes * sum(t["chunks"] for t in stats) and other.launches == 0,
              f"{phase} ran its kernel {kernel.launches} times, the other {other.launches} times for {stats}")
        summary = check_solutions(robot, sols_mb, valids_mb, targets_mb, 0.99, 0.01)
        emit(phase, t0, n=N_MEGABATCH, **summary, wall_s=mb_s, sols_per_s=N_MEGABATCH / mb_s, tiers=stats,
             kernel_launches=kernel.launches, other_kernel_launches=other.launches)
        return stats

    stats = megabatch(solver, "megabatch", fused_mlp, fused_mlp_bf16)
    stats_bf16 = megabatch(solver_bf16, "megabatch_bf16", fused_mlp_bf16, fused_mlp)

    # 11. diverse: 16 of 128 candidates for one pose, against the first 16 raw candidates.
    t0 = time.perf_counter()
    pose = targets[0]
    n_div, oversample = 16, 8
    fused_mlp.launches = 0
    fused_mlp_bf16.launches = 0
    raw = solver.generate_ik_solutions(pose, n=n_div * oversample, generator=torch.Generator(device=dev).manual_seed(5))
    div = solver.generate_diverse_ik_solutions(pose, n_div, oversample=oversample,
                                               generator=torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    check(fused_mlp.launches == 2 * 2 * hp.nb_nodes and fused_mlp_bf16.launches == 0,
          f"diverse ran K1 {fused_mlp.launches} times, K1' {fused_mlp_bf16.launches} times")

    def min_pairwise(x):
        d = torch.cdist(x.double(), x.double())
        return float(d[~torch.eye(x.shape[0], dtype=torch.bool, device=x.device)].min())

    check(tuple(div.shape) == (n_div, robot.ndof) and bool(torch.isfinite(div).all()), "bad diverse solutions")
    check(not bool(robot.joint_limits_exceeded(div).any()), "diverse solutions outside joint limits")
    check(torch.unique(div, dim=0).shape[0] == n_div, "a diverse solution is repeated")
    check(all(bool((raw == row).all(dim=1).any()) for row in div), "a diverse solution is not a candidate")
    d_div, d_raw = min_pairwise(div), min_pairwise(raw[:n_div])
    check(d_div > d_raw, f"diverse min pairwise distance {d_div} <= raw {d_raw}")
    emit("diverse", t0, n=n_div, oversample=oversample, min_pairwise_rad=d_div, raw_min_pairwise_rad=d_raw,
         kernel_launches=fused_mlp.launches)

    # 12. K1 vs plain at the rows the megabatch's chunks (a chunk's poses times
    # its tier's repeat count) and the diverse path gave it; K1' vs its plain
    # version at the rows the bf16 megabatch gave it.
    t0 = time.perf_counter()
    path_batches = sorted({size * t["repeat"] for t in stats for size in t["chunk_rows"]} | {n_div * oversample})
    rows_p, max_err_p, _ = kernel_rows(fused_mlp, fused_mlp_plain, subnet_bound, solver._kernel_params, path_batches,
                                       torch.Generator(device=dev).manual_seed(1), close_fp32)
    path_batches_b = sorted({size * t["repeat"] for t in stats_bf16 for size in t["chunk_rows"]})
    rows_pb, max_err_pb, _ = kernel_rows(fused_mlp_bf16, fused_mlp_bf16_plain, subnet_bound_bf16,
                                         solver_bf16._kernel_params, path_batches_b,
                                         torch.Generator(device=dev).manual_seed(2), close_bf16)
    emit("kernel_vs_plain_paths", t0, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, tight=KERNEL_FP32_TIGHT,
         tight_share=KERNEL_FP32_TIGHT_SHARE, batches=path_batches, rows=rows_p, batches_bf16=path_batches_b,
         bf16_tight=KERNEL_BF16_TIGHT, bf16_tight_share=KERNEL_BF16_TIGHT_SHARE, bf16_loose=KERNEL_BF16_LOOSE,
         rows_bf16=rows_pb)

    # 13-15. Training, with every file under a temporary cache tree.
    with tempfile.TemporaryDirectory(prefix="ikflow_chip_smoke_") as tmp:
        training_launches = training_phases(hp, robot, targets, exact_kw, dev, tmp)

    # 16. K1 and K1' against their plain versions at the rows each validation
    # gave them (val_set_size poses x samples_per_pose).
    from ikflow_tpu_torch.training import TrainConfig

    t0 = time.perf_counter()
    val_rows = [TrainConfig().val_set_size * TrainConfig().samples_per_pose]
    rows_t, max_err_t, _ = kernel_rows(fused_mlp, fused_mlp_plain, subnet_bound, solver._kernel_params, val_rows,
                                       torch.Generator(device=dev).manual_seed(4), close_fp32)
    rows_tb, max_err_tb, _ = kernel_rows(fused_mlp_bf16, fused_mlp_bf16_plain, subnet_bound_bf16,
                                         solver_bf16._kernel_params, val_rows,
                                         torch.Generator(device=dev).manual_seed(5), close_bf16)
    emit("kernel_vs_plain_training", t0, batches=val_rows, rows=rows_t, rows_bf16=rows_tb)

    print(json.dumps({"kernels": [
        kernel_entry("fused_mlp", "bf16_hidden=False: fp32 contract, hidden layers 3xTF32 on wgmma m64n128k8 "
                     "with packed tf32 hi/lo weight planes, 64-row tiles split over 8-CTA clusters, "
                     "a staging warpgroup, first/last layer fp32 FFMA",
                     "ikflow_tpu_torch/csrc/fused_mlp.cu", main_path_launches, max(max_err, max_err_p, max_err_t), headline,
                     training_launches["fused_mlp"]),
        kernel_entry("fused_mlp_bf16", "bf16_hidden=True: hidden layers bf16 on wgmma m64n128k16 with fp32 "
                     "accumulation, 64-row tiles split over 8-CTA clusters, weights packed once and streamed by "
                     "cp.async.bulk into a 4-slot mbarrier ring, activations pulled from the peers over DSMEM by a "
                     "staging warpgroup, two CTAs per SM, first/last layer fp32 FFMA",
                     "ikflow_tpu_torch/csrc/fused_mlp_bf16.cu", main_path_launches_bf16,
                     max(max_err_b, max_err_pb, max_err_tb),
                     headline_b, training_launches["fused_mlp_bf16"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"total_seconds": round(time.perf_counter() - t_all, 3)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
