"""Convert a softflow-conditioned deploy artifact into a warm-start init for a
sigmoid-head model without softflow, of the same depth.

Port of ``scripts_dev/convert_softflow_init.py``. Why this is exact for the
coupling blocks: softflow adds one conditional column (the noise scale,
``dim_cond`` 7 -> 8) that is always zero at inference (the solver pads it
with zeros), so the last input row of each coupling subnet's first layer
never contributes to an inference output. Dropping that row gives a
``dim_cond`` 7 network whose inverse equals the softflow network's at noise
scale 0; it is checked here before writing (64 probes, max |dq| < 1e-5; on a
card both inverses run the subnet kernel). The sigmoid head has no
parameters, so the same parameters warm-start ``sigmoid_on_output`` training.
The artifact is stored as float16.

Usage: python -m ikflow_tpu_torch.scripts_dev.convert_softflow_init SRC.npz DST.npz [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

N_PROBES = 64
MAX_DQ = 1e-5


def convert(flat, dst_flow):
    """The converted parameters (float32 numpy leaves, in ``dst_flow``'s
    structure) and the number of rows dropped: the last input row of every
    leaf with one more input row than ``dst_flow`` expects."""
    dropped = 0

    def leaf(key, shape):
        nonlocal dropped
        arr = flat[key]
        if arr.shape != tuple(shape):
            if not (arr.ndim == 2 and arr.shape[0] == shape[0] + 1 and arr.shape[1] == shape[1]):
                raise AssertionError(f"unexpected mismatch for {key}: {arr.shape} vs {tuple(shape)}")
            arr = arr[:-1]  # the softflow column is the last cond input row
            dropped += 1
        return arr

    params = tuple({s: [{k: leaf(f"{i}/{s}/{j}/{k}", layer[k]) for k in ("w", "b")} for j, layer in enumerate(blk[s])]
                    for s in ("s1", "s2")} for i, blk in enumerate(dst_flow.param_shapes()))
    return params, dropped


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ikflow_tpu_torch.config import resolve_device
    from ikflow_tpu_torch.flow import FlowHyperParams, build_flow
    from ikflow_tpu_torch.robots import get_robot
    from ikflow_tpu_torch.training.checkpoints import export_deploy, params_from_jax, read_artifact

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    header, stored = read_artifact(args.src)
    flat = {k: np.asarray(v, dtype=np.float32) for k, v in stored.items()}
    src_hp = FlowHyperParams.from_dict(header["hyper_parameters"])
    if not (src_hp.softflow_enabled and not src_hp.sigmoid_on_output):
        raise AssertionError("source must be a softflow-conditioned affine-head artifact")
    robot = get_robot(header["robot_name"])

    # Target hyperparameters: same stack, sigmoid head, no softflow.
    dst_hp = FlowHyperParams.from_dict(header["hyper_parameters"])
    dst_hp.softflow_enabled = False
    dst_hp.sigmoid_on_output = True
    params, dropped = convert(flat, build_flow(dst_hp, robot))
    if dropped != 2 * len(params):
        raise AssertionError(f"expected 2 drops per block, got {dropped}")

    # The converted (dim_cond 7) network against the source at softflow
    # scale 0, before the head: an affine-head dim_cond-7 flow against the
    # source flow.
    chk_hp = FlowHyperParams.from_dict(header["hyper_parameters"])
    chk_hp.softflow_enabled = False  # affine head, dim_cond 7
    chk_flow, src_flow = build_flow(chk_hp, robot), build_flow(src_hp, robot)
    src_params = params_from_jax(
        tuple({s: [{k: flat[f"{i}/{s}/{j}/{k}"] for k in ("w", "b")} for j in range(len(blk[s]))]
               for s in ("s1", "s2")} for i, blk in enumerate(src_flow.param_shapes())), device)
    gen = torch.Generator(device=device).manual_seed(1)
    z0 = torch.randn((N_PROBES, dst_hp.dim_latent_space), generator=gen, device=device)
    cond7 = torch.randn((N_PROBES, 7), generator=gen, device=device)
    cond8 = torch.cat([cond7, cond7.new_zeros((N_PROBES, 1))], dim=1)
    with torch.no_grad():
        q_src, _ = src_flow.inverse(src_flow.kernel_params(src_params), z0, cond8)
        q_chk, _ = chk_flow.inverse(chk_flow.kernel_params(params_from_jax(params, device)), z0, cond7)
    err = float((q_src - q_chk).abs().max())
    if not err < MAX_DQ:
        raise AssertionError(f"converted network diverges from source at c=0: max |dq| = {err}")
    print(f"block equivalence verified: max |dq| = {err:.2e} over {N_PROBES} probes")

    path = export_deploy(args.dst, params_from_jax(params), dst_hp, robot.name,
                         global_step=header.get("global_step"), dtype="float16")
    print(f"wrote warm-start init -> {path} (source {args.src}, "
          f"step {header.get('global_step')}, dropped {dropped} softflow rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
