"""Re-stamp a deploy artifact that shipped without a quality header.

Port of ``scripts_dev/stamp_quality_headers.py``. The quality is re-measured
with the trainer's export-time procedure, ``Trainer.validate`` on the test
split of ``build_dataset(robot, training_set_size=256)`` (seed 0) with
latents from a generator seeded ``seed + 7``, on the registered model's
weights; above ``--gate_mm`` the stamp is refused. Only the header is
rewritten, in place: the arrays are untouched.

Caveat (recorded in the stamped ``quality_source``): runs trained with
``--on_device_data`` drew their test split from ``build_dataset_resident``,
another draw than ``build_dataset``'s split used here. The stamped number
is a same-distribution validation at the default 128-pose size, not a
replay of the training run's own split.

Usage: python -m ikflow_tpu_torch.scripts_dev.stamp_quality_headers --model_name M --npz X.npz --gate_mm G
    [--val_set_size 128] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

SOURCE = ("re-measured post-hoc (ikflow_tpu_torch.scripts_dev.stamp_quality_headers): build_dataset seed-0 "
          "split, n={n} — NOT the training run's own split if it used --on_device_data")


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ikflow_tpu_torch.config import resolve_device
    from ikflow_tpu_torch.registry import get_ik_solver
    from ikflow_tpu_torch.training.checkpoints import read_artifact, write_artifact
    from ikflow_tpu_torch.training import TrainConfig, Trainer
    from ikflow_tpu_torch.training.dataset import build_dataset

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model_name", required=True)
    ap.add_argument("--npz", required=True)
    ap.add_argument("--gate_mm", type=float, required=True,
                    help="recorded as quality_gate_mm; the stamp REFUSES if the measured val exceeds it (same "
                         "contract as export_deploy)")
    ap.add_argument("--val_set_size", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    solver, hp = get_ik_solver(args.model_name, device=device)
    robot = solver.robot
    # A tiny train split (validate reads none of it); the test split is the
    # same seed-0 draw at every call.
    dataset = build_dataset(robot, training_set_size=256, device=device)
    cfg = TrainConfig(val_set_size=args.val_set_size)
    trainer = Trainer(solver.flow, robot, cfg, log_dir=None, device=device)
    val = trainer.validate(solver.params, dataset, torch.Generator(device=device).manual_seed(cfg.seed + 7), step=0)
    l2, ang = val["val/l2_error_mm"], val["val/angular_error_deg"]
    print(f"{args.model_name}: measured val l2 {l2:.2f} mm / ang {ang:.2f} deg")
    if not (np.isfinite(l2) and l2 <= args.gate_mm):
        raise AssertionError(f"measured val {l2:.2f} mm exceeds gate {args.gate_mm} — refusing to stamp")

    header, arrays = read_artifact(args.npz)
    header["quality"] = {"val_l2_error_mm": float(l2), "val_angular_error_deg": float(ang)}
    header["quality_gate_mm"] = args.gate_mm
    header["quality_source"] = SOURCE.format(n=args.val_set_size)
    write_artifact(args.npz, header, arrays)
    print(f"stamped {args.npz}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
