# The bf16 flow on the card against the plain bf16 flow on the CPU, over many
# draws of 64 rows: how often one draw's largest gap passes a bound such as
# ``chip_smoke.py``'s FLOW_BF16_ATOL, for K1' and for a witness that sums
# the same function in another order (the plain version on the card).
#
#     python3 bf16_flow_draws.py [ROOT]
#
# ROOT is the checkout whose ``ikflow_tpu_torch`` is measured (default: the
# one holding this script), so two commits can be read with one script. Each
# of 48 draws is a latent from seed 1000 + d and 64 of 1000 reachable targets
# (seed 42, as chip_smoke.py draws them). Prints the card's name and power
# limit, then one JSON object: for each comparison, the largest gap over all draws,
# the median of the per-draw largest gaps, the draws over 2e-2, the largest
# per-draw mean gap and the draws whose mean is over 1e-3. Needs a CUDA
# device.

import dataclasses
import json
import os
import subprocess
import sys

import torch

DRAWS = 48


def gap(a, b):
    e = (a.cpu() - b.cpu()).abs()
    return float(e.max()), float(e.mean())


def main():
    if not torch.cuda.is_available():
        sys.exit("bf16_flow_draws: no CUDA device available")
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    from ikflow_tpu_torch import cuda_build
    from ikflow_tpu_torch.flow.fused_subnet import fused_mlp_bf16_plain
    from ikflow_tpu_torch.registry import get_ik_solver
    from ikflow_tpu_torch.solver import IKFlowSolver

    cuda_build.build("fused_mlp")
    cuda_build.build("fused_mlp_bf16")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip(), flush=True)
    solver, hp = get_ik_solver("panda__full__sigmoid", device="cuda")
    slv = IKFlowSolver(dataclasses.replace(hp, bf16_hidden=True), solver.robot, params=solver.params, device="cuda")
    dev = torch.device("cuda")
    robot = solver.robot
    targets = robot.forward_kinematics(
        robot.sample_joint_angles(1000, torch.Generator(device=dev).manual_seed(42), joint_limit_eps=0.02))
    params_cpu = [{k: [{n: t.cpu() for n, t in lay.items()} for lay in blk[k]] for k in blk} for blk in solver.params]
    gaps = {"kernel_vs_cpu": [], "plain_card_vs_cpu": []}
    for d in range(DRAWS):
        latent = torch.randn((64, hp.dim_latent_space), generator=torch.Generator(device=dev).manual_seed(1000 + d),
                             device=dev)
        cond = targets[64 * (d % 15): 64 * (d % 15) + 64]
        q_kernel, _ = slv.flow.inverse(slv._kernel_params, latent, cond)
        kernel = slv.flow._subnet_kernel
        slv.flow._subnet_kernel = fused_mlp_bf16_plain  # the witness: plain sums on the card
        q_plain, _ = slv.flow.inverse(slv.params, latent, cond)
        slv.flow._subnet_kernel = kernel
        q_cpu, _ = slv.flow.inverse(params_cpu, latent.cpu(), cond.cpu())
        gaps["kernel_vs_cpu"].append(gap(q_kernel, q_cpu))
        gaps["plain_card_vs_cpu"].append(gap(q_plain, q_cpu))
    summary = {}
    for name, rows in gaps.items():
        maxes = sorted(m for m, _ in rows)
        summary[name] = {"max_abs_err": maxes[-1], "median_draw_max_abs_err": maxes[len(maxes) // 2],
                         "draws_over_2e-2": sum(m > 2e-2 for m in maxes),
                         "max_draw_mean_abs_err": max(m for _, m in rows),
                         "draws_mean_over_1e-3": sum(m > 1e-3 for _, m in rows)}
    print(json.dumps({"root": root, "draws": DRAWS, "rows_per_draw": 64, **summary}), flush=True)


if __name__ == "__main__":
    main()
