import faulthandler; faulthandler.dump_traceback_later(300, exit=True)  # noqa: E702  watchdog: a hang exits 1 with a traceback

# Smoke run of the PyTorch port on one NVIDIA GPU: build the CUDA kernel,
# hold it against its plain version, and drive the serving path end to end.
#
#     python3 chip_smoke.py
#
# Runs from the root of a checkout with no install, network or git. Builds
# ``ikflow_tpu_torch/csrc/fused_mlp.cu`` with nvcc into ``build/``, loads
# ``panda__full__sigmoid`` (12 GLOW blocks, subnets 10/11 -> 1024 x 3 -> 8/6,
# fp32) from ``models/panda__full_sigmoid.npz``, and runs:
#
# 1. device: the card, its power limit and the TF32 flags;
# 2. kernel vs plain: the fused subnet MLP against addmm + leaky_relu on the
#    shipped weights of block 0, at the batch sizes the serving path gives it;
# 3. approx: ``generate_ik_solutions`` on 1000 poses (24 kernel launches);
# 4. exact: ``generate_exact_ik_solutions`` on 1000 reachable poses, tiers
#    (1, 3, 10), 3 LM steps, 1 mm / 0.01 rad, checked by an independent float64
#    forward kinematics;
# 5. profile: device time by kernel over a second, traced exact solve;
# 6. flow_vs_cpu: the card's flow against the plain flow on the CPU, 64 rows.
#
# Every phase prints one JSON line; any failed check raises. The last line is
# ``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero and
# prints no result.

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

MODEL = "panda__full__sigmoid"
N_POSES = 1000
KERNEL_ATOL = 1e-4  # fp32 sums over K = 1024 in another order than cuBLAS
KERNEL_RTOL = 1e-4
FLOW_ATOL = 1e-3  # kernel flow on the card vs plain flow on the CPU, radians, after 24 subnets
FK_SLACK_POS = 1e-5  # float64 recheck of fp32 solutions: metres
FK_SLACK_ROT = 1e-4  # radians
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


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


def subnet_bound(B, layers):
    flops = 2 * B * sum(lay["w"].shape[0] * lay["w"].shape[1] for lay in layers)
    nbytes = 4 * (B * layers[0]["w"].shape[0] + B * layers[-1]["w"].shape[1]
                  + sum(lay["w"].numel() + lay["b"].numel() for lay in layers))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


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
    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (us / 1e3, evt.count)
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    device_ms = sum(ms for ms, _ in kernels.values())
    mlp_ms = sum(ms for k, (ms, _) in kernels.items() if "fused_mlp" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
        "kernel_launches": sum(c for _, c in kernels.values()), "fused_mlp_ms": mlp_ms,
        "fused_mlp_share_of_device": mlp_ms / device_ms,
        "top": [{"kernel": k[:80], "ms": ms, "count": c} for k, (ms, c) in top],
    }


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available; this script runs on the GPU only")

    from ikflow_tpu_torch import cuda_build
    from ikflow_tpu_torch.flow.fused_subnet import fused_mlp, fused_mlp_plain
    from ikflow_tpu_torch.registry import get_ik_solver

    t_all = time.perf_counter()

    # Build: one nvcc per source, with its resource report.
    t0 = time.perf_counter()
    res = cuda_build.build("fused_mlp")
    print(res.log.strip(), flush=True)
    emit("build", t0, library=os.path.relpath(res.path, ROOT), nvcc_seconds=round(res.seconds, 3))

    # 1. device
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    solver, hp = get_ik_solver(MODEL, device="cuda")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("device", t0, nvidia_smi=smi, name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, capability=list(torch.cuda.get_device_capability(0)),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32, cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         model=MODEL, blocks=hp.nb_nodes, width=hp.coeff_fn_internal_size)
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 must be off")

    # 2. kernel vs plain on the shipped weights of block 0.
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, max_err, headline = [], 0.0, None
    for B in (1000, 3000, 10000, 1):  # tier 1, 2 and 3 of 1000 poses, and one pose
        for sname in ("s1", "s2"):
            layers = solver.params[0][sname]
            x = torch.randn((B, layers[0]["w"].shape[0]), generator=gen, device=dev)
            out_k = fused_mlp(x, layers)
            torch.cuda.synchronize()
            out_p = fused_mlp_plain(x, layers)
            err = float((out_k - out_p).abs().max())
            check(bool(torch.isfinite(out_k).all()), f"non-finite kernel output at B={B} {sname}")
            check(torch.allclose(out_k, out_p, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
                  f"kernel disagrees with plain at B={B} {sname}: max abs err {err}")
            iters = 20 if B >= 10000 else 50
            ms = cuda_ms(lambda: fused_mlp(x, layers), iters)
            plain_ms = cuda_ms(lambda: fused_mlp_plain(x, layers), iters)
            bound_ms, bound_by, flops = subnet_bound(B, layers)
            row = {"B": B, "subnet": sname, "shape": [layers[0]["w"].shape[0], layers[-1]["w"].shape[1]],
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "kernel_tflops": flops / ms / 1e9}
            rows.append(row)
            max_err = max(max_err, err)
            if B == 10000 and sname == "s1":
                headline = row
    emit("kernel_vs_plain", t0, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, rows=rows)

    # Targets: FK of in-limit samples, as the JAX package's contract draws them.
    robot = solver.robot
    g = torch.Generator(device=dev).manual_seed(42)
    q_gt = robot.sample_joint_angles(N_POSES, g, joint_limit_eps=0.02)
    targets = robot.forward_kinematics(q_gt)

    # 3. approx: the main path starts here, so the count starts at 0.
    fused_mlp.launches = 0
    t0 = time.perf_counter()
    sols, pos_err, rot_err, jle = solver.generate_ik_solutions(targets, generator=g, return_detailed=True)
    torch.cuda.synchronize()
    approx_s = time.perf_counter() - t0
    approx_launches = fused_mlp.launches
    check(tuple(sols.shape) == (N_POSES, robot.ndof) and bool(torch.isfinite(sols).all()), "bad approx solutions")
    check(not bool(jle.any()), "approx solutions outside joint limits")
    check(approx_launches == 2 * hp.nb_nodes, f"expected {2 * hp.nb_nodes} launches, got {approx_launches}")
    emit("approx", t0, n=N_POSES, wall_s=approx_s, kernel_launches=approx_launches,
         mean_pos_err_mm=1e3 * float(pos_err.mean()), mean_rot_err_deg=float(torch.rad2deg(rot_err).mean()))

    # 4. exact
    t0 = time.perf_counter()
    launches_before = fused_mlp.launches
    sols, valids, tier_counts = solver.generate_exact_ik_solutions(
        targets, repeat_counts=(1, 3, 10), pos_error_threshold=1e-3, rot_error_threshold=0.01,
        n_opt_steps_max=3, generator=g, return_tier_counts=True,
    )
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    exact_launches = fused_mlp.launches - launches_before
    main_path_launches = fused_mlp.launches
    tiers = [int(c) for c in tier_counts.cpu()]
    tiers_run = 1 + sum(1 for c in tiers[:-1] if c < N_POSES)
    check(exact_launches == 2 * hp.nb_nodes * tiers_run,
          f"expected {2 * hp.nb_nodes * tiers_run} launches for {tiers_run} tiers, got {exact_launches}")
    v = valids.cpu().numpy()
    s = sols.cpu().double().numpy()[v]
    low = robot.limits_low().double().numpy()
    high = robot.limits_high().double().numpy()
    check(v.mean() >= 0.99, f"only {v.sum()}/{N_POSES} poses solved")
    check(bool(((s >= low - 1e-6) & (s <= high + 1e-6)).all()), "a valid solution lies outside the joint limits")
    R, p = fk64(robot.joints, s)
    t = targets.cpu().double().numpy()[v]
    pos64 = np.linalg.norm(p - t[:, :3], axis=-1)
    Rt = quat_to_matrix64(t[:, 3:] / np.linalg.norm(t[:, 3:], axis=-1, keepdims=True))
    cos = (np.einsum("nij,nij->n", Rt, R) - 1.0) / 2.0
    rot64 = np.arccos(np.clip(cos, -1.0, 1.0))
    check(float(pos64.max()) <= 1e-3 + FK_SLACK_POS, f"float64 FK recheck: max pos err {pos64.max()}")
    check(float(rot64.max()) <= 0.01 + FK_SLACK_ROT, f"float64 FK recheck: max rot err {rot64.max()}")
    emit("exact", t0, n=N_POSES, valid=int(v.sum()), valid_fraction=float(v.mean()), tier_counts=tiers,
         tiers_run=tiers_run, kernel_launches=exact_launches, wall_s=exact_s, sols_per_s=N_POSES / exact_s,
         fk64_max_pos_err_mm=1e3 * float(pos64.max()), fk64_max_rot_err_deg=float(np.degrees(rot64.max())))

    # Where the time of an exact solve goes: a second, traced solve.
    t0 = time.perf_counter()
    emit("profile", t0, **profile_exact(solver, targets, g))

    # Reference on a small input: the card's flow (kernel) vs the plain flow on the CPU.
    t0 = time.perf_counter()
    latent = torch.randn((64, hp.dim_latent_space), generator=gen, device=dev)
    q_card, _ = solver.flow.inverse(solver.params, latent, targets[:64])
    params_cpu = [{k: [{n: t.cpu() for n, t in lay.items()} for lay in blk[k]] for k in blk} for blk in solver.params]
    q_cpu, _ = solver.flow.inverse(params_cpu, latent.cpu(), targets[:64].cpu())
    flow_err = float((q_card.cpu() - q_cpu).abs().max())
    check(flow_err <= FLOW_ATOL, f"card flow vs CPU flow: max abs err {flow_err} > {FLOW_ATOL}")
    emit("flow_vs_cpu", t0, rows=64, max_abs_err=flow_err, atol=FLOW_ATOL)

    print(json.dumps({"kernels": [{
        "name": "fused_mlp",
        "route": "cuda",
        "source": "ikflow_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "ikflow_tpu/flow/pallas_subnet.py:97",
        "launches": main_path_launches,
        "max_abs_err": max_err,
        "ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"],
        "bound_by": headline["bound_by"],
        "library_ms": None,
        "at": {"B": headline["B"], "subnet": headline["subnet"]},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"total_seconds": round(time.perf_counter() - t_all, 3)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
    faulthandler.cancel_dump_traceback_later()
