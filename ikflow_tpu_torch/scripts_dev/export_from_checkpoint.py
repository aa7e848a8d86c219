"""Fallback deploy export: restore a ``train`` run's newest checkpoint and
write the ``.npz`` deploy artifact, for a run stopped between its last
checkpoint and its ``--export`` step.

Port of ``scripts_dev/export_from_checkpoint.py``. The port's checkpoints
are ``torch.save`` files (``<ckpt_dir>/<step>/checkpoint.pt``), not orbax
trees. The architecture flags must match the run: the restored parameters'
shapes are checked against the flow they build (``--nb_nodes``,
``--dim_latent_space``, ``--disable_softflow``), and against the run's
``config.json`` beside ``metrics.jsonl`` where it exists (with
``--sigmoid_on_output``, which changes no shape). The quality is the run's
latest validation record at the restored step or before it; without one the
export is refused. The gate is ``--gate_mm``, else the registry's policy with
the incumbent rule (``training.checkpoints.resolve_export_gate``), as the
trainer's ``--export`` resolves it.

Usage: python -m ikflow_tpu_torch.scripts_dev.export_from_checkpoint --ckpt_dir RUN/checkpoints
    --robot_name panda --out X.npz --dim_latent_space 7 [--device cpu] ...
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional, Sequence


def check_architecture(params, flow, args, run_config: Optional[dict]) -> None:
    """Raise where the flags build another architecture than the run's."""
    def shapes(tree, shape):
        return [shape(lay[k]) for blk in tree for s in ("s1", "s2") for lay in blk[s] for k in ("w", "b")]

    got, want = shapes(params, lambda t: tuple(t.shape)), shapes(flow.param_shapes(), tuple)
    if got != want:
        raise ValueError(
            f"the checkpoint's parameters ({len(params)} blocks, first layer {got[0]}) do not fit the flags "
            f"--nb_nodes {args.nb_nodes} --dim_latent_space {args.dim_latent_space} --disable_softflow "
            f"{args.disable_softflow}, which build {flow.hp.nb_nodes} blocks, first layer {want[0]}")
    run_hp = (run_config or {}).get("hyper_parameters") or {}
    for field in ("sigmoid_on_output", "softflow_enabled"):
        if field in run_hp and run_hp[field] != getattr(flow.hp, field):
            raise ValueError(f"the run's config.json has {field}={run_hp[field]!r}, the flags build "
                             f"{field}={getattr(flow.hp, field)!r}")


def val_record(metrics_path: str, step: int):
    """(val l2 mm, val angular deg, its step) of the latest validation
    record at ``step`` or before, or (None, None, None)."""
    last_val = last_ang = val_step = None
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            for line in f:
                try:
                    m = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "val/l2_error_mm" in m and float(m.get("step", math.inf)) <= step:
                    last_val = float(m["val/l2_error_mm"])
                    last_ang = float(m.get("val/angular_error_deg", float("nan")))
                    val_step = m.get("step")
    return last_val, last_ang, val_step


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ikflow_tpu_torch.config import resolve_device
    from ikflow_tpu_torch.flow import FlowHyperParams, build_flow
    from ikflow_tpu_torch.robots import get_robot
    from ikflow_tpu_torch.training.checkpoints import export_deploy, resolve_export_gate, restore_checkpoint

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--robot_name", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--nb_nodes", type=int, default=12)
    ap.add_argument("--dim_latent_space", type=int, required=True)
    ap.add_argument("--dtype", type=str, default=None,
                    help="storage dtype for the artifact (e.g. float16); native when omitted")
    ap.add_argument("--sigmoid_on_output", action="store_true")
    ap.add_argument("--disable_softflow", action="store_true",
                    help="must match the training run: softflow adds a conditioning dim, so a mismatch fails "
                         "the shape check")
    ap.add_argument("--gate_mm", type=float, default=None,
                    help="explicit quality-gate override (mm). Default: resolved from the per-model policy and "
                         "the incumbent rule (training/checkpoints.py::resolve_export_gate), as the trainer's "
                         "--export path")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    robot = get_robot(args.robot_name)
    hp = FlowHyperParams()
    hp.nb_nodes = args.nb_nodes
    hp.dim_latent_space = args.dim_latent_space
    hp.sigmoid_on_output = args.sigmoid_on_output
    hp.softflow_enabled = not args.disable_softflow
    flow = build_flow(hp, robot)
    restored, step = restore_checkpoint(args.ckpt_dir, device=device)
    run_dir = os.path.dirname(os.path.abspath(args.ckpt_dir))
    config_path = os.path.join(run_dir, "config.json")
    run_config = None
    if os.path.exists(config_path):
        with open(config_path) as f:
            run_config = json.load(f)
    check_architecture(restored["params"], flow, args, run_config)

    # The validation record matched to the restored step (checkpoint_every
    # and eval_every need not coincide, so the last record can describe
    # weights newer than the checkpoint): the latest one at or before it, and
    # a refusal where there is none, since a gate passed on another number is
    # no gate.
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    last_val, last_ang, val_step = val_record(metrics_path, step)
    if last_val is None:
        print(f"EXPORT REFUSED: no val record at step <= {step} in {metrics_path} — "
              f"cannot grade the restored weights")
        return 1

    gate_mm, gate_source = resolve_export_gate(args.out, args.gate_mm)
    print(f"deploy gate: {gate_mm} mm ({gate_source}); "
          f"val {last_val:.2f} mm at step {val_step} (restored step {step})")
    quality = {"val_l2_error_mm": last_val, "val_angular_error_deg": last_ang,
               "quality_source": f"metrics.jsonl step {val_step} (checkpoint step {step})"}
    path = export_deploy(args.out, restored["params"], hp, robot.name, global_step=step, dtype=args.dtype,
                         quality=quality, max_val_l2_mm=gate_mm)
    print(f"exported {path} from checkpoint step {step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
