"""Grow a trained N-block flow artifact into a deeper M-block warm-start init.

Port of ``scripts_dev/grow_flow_init.py``. Blocks 0..N-1 are copied from the
source; blocks N..M-1 get fresh subnets whose last linear layer is zero, so
each new coupling is the identity (s = 0, t = 0 after the soft clamp), the
GLOW paper's zero-init trick. The new blocks' fixed permutations still apply
(per block index, as ``build_flow`` makes them), but permutations of a
standard-Gaussian latent change nothing observable: the grown model's NLL is
the source's at step 0, checked here on 64 configurations (max |dNLL| and
max |d||z||| < 1e-3) before writing. The artifact is stored as float16.

Usage: python -m ikflow_tpu_torch.scripts_dev.grow_flow_init SRC.npz DST.npz NB_NODES [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

N_CHECK = 64
MAX_GAP = 1e-3


def grow(src_params, dst_flow, generator: torch.Generator):
    """``dst_flow``'s parameters: ``src_params``' blocks first, then fresh
    blocks (``dst_flow.init`` from ``generator``) whose subnets' last layers
    are zero."""
    grown = list(dst_flow.init(generator))
    grown[: len(src_params)] = src_params  # the permutations are per block index, so these line up
    for blk in grown[len(src_params):]:
        for s in ("s1", "s2"):
            blk[s][-1] = {k: torch.zeros_like(t) for k, t in blk[s][-1].items()}
    return tuple(grown)


def nll_and_norm(flow, params, x, cond):
    z, logdet = flow.forward(params, x, cond)
    return 0.5 * torch.sum(z * z, dim=1) - logdet, torch.linalg.vector_norm(z, dim=1)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ikflow_tpu_torch.config import resolve_device
    from ikflow_tpu_torch.flow import FlowHyperParams, build_flow
    from ikflow_tpu_torch.robots import get_robot
    from ikflow_tpu_torch.training.checkpoints import export_deploy, load_deploy, read_deploy_header

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("nb_nodes", type=int)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    header = read_deploy_header(args.src)
    src_hp = FlowHyperParams.from_dict(header["hyper_parameters"])
    if not args.nb_nodes > src_hp.nb_nodes:
        raise AssertionError((args.nb_nodes, src_hp.nb_nodes))
    robot = get_robot(header["robot_name"])
    src_flow = build_flow(src_hp, robot)
    src_params, _ = load_deploy(args.src, src_flow.param_shapes(), device)

    dst_hp = FlowHyperParams.from_dict(header["hyper_parameters"])
    dst_hp.nb_nodes = args.nb_nodes
    dst_flow = build_flow(dst_hp, robot)
    grown = grow(src_params, dst_flow, torch.Generator(device=device).manual_seed(1))

    # Equal NLL: the identity couplings and their permutations do not change
    # the density (|det P| = 1, isotropic base).
    q = robot.sample_joint_angles(N_CHECK, torch.Generator(device=device).manual_seed(2))
    x = torch.cat([q, q.new_zeros((N_CHECK, dst_hp.dim_latent_space - robot.ndof))], dim=1)
    cond = robot.forward_kinematics(q)
    with torch.no_grad():
        (nll_src, norm_src), (nll_dst, norm_dst) = (nll_and_norm(f, p, x, cond) for f, p in
                                                    ((src_flow, src_params), (dst_flow, grown)))
    err, norm_err = float((nll_src - nll_dst).abs().max()), float((norm_src - norm_dst).abs().max())
    if not (err < MAX_GAP and norm_err < MAX_GAP):
        raise AssertionError((err, norm_err))
    print(f"grow verified: max |dNLL| = {err:.2e}, max |d||z||| = {norm_err:.2e}")

    path = export_deploy(args.dst, grown, dst_hp, robot.name, global_step=header.get("global_step"),
                         dtype="float16")
    print(f"wrote grown warm-start init -> {path} ({src_hp.nb_nodes} -> {args.nb_nodes} blocks, source {args.src})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
