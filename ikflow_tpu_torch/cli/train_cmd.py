"""``ikflow-torch train``: train a conditional flow for a robot.

Port of ``ikflow_tpu/cli/train_cmd.py``, with the same flags and defaults
(optimizer adamw, lr 1e-4, batch 512, gamma 0.9795, cadences in steps),
``--smoke`` for a tiny end-to-end run, ``--resume`` from a checkpoint
directory, ``--init_npz`` to warm-start from a deploy artifact, and
``--export`` to write a gated deploy artifact at the end. ``--device``
(default ``cuda``) picks the device. ``--data_parallel`` joins the process
group of a multi-process launch (``parallel.mesh.initialize_multihost``) and
splits each batch over a mesh of every CUDA device (with ``--device cpu``,
a mesh of the CPU); as in the JAX package, it never builds the dataset on
the device. On a card the steps and validation replay captured CUDA graphs,
with ``--data_parallel`` too.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time


def add_parser(sub):
    p = sub.add_parser("train", help="train an IKFlow model")
    p.add_argument("--robot_name", type=str, required=True)
    p.add_argument("--coupling_layer", type=str, default="glow")
    p.add_argument("--nb_nodes", type=int, default=12)
    p.add_argument("--dim_latent_space", type=int, default=9)
    p.add_argument("--coeff_fn_config", type=int, default=3)
    p.add_argument("--coeff_fn_internal_size", type=int, default=1024)
    p.add_argument("--rnvp_clamp", type=float, default=2.5)
    p.add_argument("--softflow_noise_scale", type=float, default=0.001)
    p.add_argument("--disable_softflow", action="store_true")
    p.add_argument("--sigmoid_on_output", action="store_true")
    p.add_argument("--optimizer", type=str, default="adamw", choices=["adamw", "adam", "adadelta", "ranger"])
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--gamma", type=float, default=0.9795)
    p.add_argument("--step_lr_every", type=int, default=int(2.5e6 / 64))
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps (stabilizes 16-block stacks at large batch)")
    p.add_argument("--gradient_clip_val", type=float, default=1.0)
    p.add_argument("--gradient_clip_algorithm", type=str, default="value", choices=["value", "norm"],
                   help="'value' clips each gradient element; 'norm' rescales the whole gradient when its "
                        "global L2 norm exceeds the clip, which bounds the step length")
    p.add_argument("--n_steps", type=int, default=250_000)
    p.add_argument("--eval_every", type=int, default=20_000)
    p.add_argument("--log_every", type=int, default=1_000)
    p.add_argument("--checkpoint_every", type=int, default=50_000)
    p.add_argument("--val_set_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset_tags", nargs="*", default=["non-self-colliding"])
    p.add_argument("--smoke", action="store_true", help="tiny model + tiny run (CI)")
    p.add_argument("--resume", type=str, default=None, help="checkpoint dir to resume from")
    p.add_argument("--init_npz", type=str, default=None,
                   help="warm-start params from a deploy .npz artifact (optimizer state and step counter "
                        "start fresh)")
    p.add_argument("--export", type=str, default=None, help="deploy .npz path to write at the end")
    p.add_argument("--export_dtype", type=str, default=None,
                   help="storage dtype for the deploy artifact (e.g. float16; cast back to fp32 at load)")
    p.add_argument("--export_gate_mm", type=float, default=None,
                   help="refuse the deploy export if the final val l2 error exceeds this (mm). Default: the "
                        "registry's export_gate_mm for the artifact (backstop 100), tightened by the "
                        "no-regression rule against an existing target artifact")
    p.add_argument("--export_force", action="store_true",
                   help="bypass the export quality gate (the header still records the metric)")
    p.add_argument("--run_dir", type=str, default=None)
    p.add_argument("--data_parallel", action="store_true", help="shard each batch over all devices")
    p.add_argument("--bf16_hidden", action="store_true",
                   help="bf16 hidden subnet layers (fp32 accumulation); the inverse runs kernel K1'")
    p.add_argument("--on_device_data", action="store_true",
                   help="dataset resident on the device, batches drawn there (no per-batch host transfer)")
    p.add_argument("--steps_per_call", type=int, default=200)
    p.add_argument("--time_budget_s", type=float, default=None,
                   help="stop at the first window boundary past this wall-clock budget")
    p.add_argument("--dataset_size", type=int, default=2_500_000)
    p.add_argument("--wandb", action="store_true",
                   help="also log to wandb when the library is available (JSONL is always written)")
    p.add_argument("--wandb_project", type=str, default="ikflow-tpu")
    p.add_argument("--device", type=str, default="cuda", help="torch device (default cuda; cpu for tests)")
    p.set_defaults(func=run)
    return p


def _file_sha256(path: str):
    if not os.path.exists(path):
        return None
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
    return h.hexdigest()


def run(args: argparse.Namespace) -> int:
    import torch

    from ikflow_tpu_torch import config
    from ikflow_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    device = config.resolve_device(args.device)
    if args.data_parallel:
        # A no-op unless the environment marks a multi-process launch; the
        # backend follows the run's device.
        initialize_multihost(device=device)

    from ikflow_tpu_torch.flow import FlowHyperParams, build_flow
    from ikflow_tpu_torch.robots import get_robot
    from ikflow_tpu_torch.training import TrainConfig, Trainer, build_dataset, load_dataset
    from ikflow_tpu_torch.training.checkpoints import (
        DeployQualityError,
        export_deploy,
        load_deploy,
        resolve_export_gate,
        restore_checkpoint,
    )
    from ikflow_tpu_torch.training.dataset import build_dataset_resident, dataset_directory, save_dataset

    hp = FlowHyperParams(
        coupling_layer=args.coupling_layer,
        nb_nodes=args.nb_nodes,
        dim_latent_space=args.dim_latent_space,
        coeff_fn_config=args.coeff_fn_config,
        coeff_fn_internal_size=args.coeff_fn_internal_size,
        rnvp_clamp=args.rnvp_clamp,
        softflow_noise_scale=args.softflow_noise_scale,
        softflow_enabled=not args.disable_softflow,
        sigmoid_on_output=args.sigmoid_on_output,
        bf16_hidden=args.bf16_hidden,
    )
    cfg = TrainConfig(
        optimizer=args.optimizer,
        learning_rate=args.learning_rate,
        batch_size=args.batch_size,
        gamma=args.gamma,
        step_lr_every=args.step_lr_every,
        warmup_steps=args.warmup_steps,
        gradient_clip=args.gradient_clip_val,
        gradient_clip_algorithm=args.gradient_clip_algorithm,
        n_steps=args.n_steps,
        eval_every=args.eval_every,
        log_every=args.log_every,
        checkpoint_every=args.checkpoint_every,
        val_set_size=args.val_set_size,
        seed=args.seed,
    )
    robot = get_robot(args.robot_name)

    if args.smoke:
        hp.nb_nodes, hp.coeff_fn_config, hp.coeff_fn_internal_size = 3, 2, 256
        hp.dim_latent_space = max(robot.ndof, 8)
        cfg.n_steps, cfg.eval_every, cfg.log_every, cfg.checkpoint_every = 200, 100, 20, 0
        cfg.batch_size, cfg.val_set_size = 256, 16
        dataset = build_dataset(robot, training_set_size=8192, test_set_size=512, chunk_size=8192, device=device)
    else:
        if hp.dim_latent_space < robot.ndof:
            raise ValueError(f"dim_latent_space ({hp.dim_latent_space}) must be >= ndof ({robot.ndof})")
        try:
            dataset = load_dataset(args.robot_name, tuple(args.dataset_tags))
        except FileNotFoundError:
            print(f"dataset not found; generating {args.dataset_size} samples on-device")
            # The dataset carries the requested tags, and a saved copy lands in
            # their directory, where load_dataset looks on the next launch.
            only_nsc = config.DATASET_TAG_NON_SELF_COLLIDING in args.dataset_tags
            if args.on_device_data and not args.data_parallel:
                # Generated and consumed on the device, and deterministic in
                # the seed, so a relaunch regenerates it instead of loading it.
                dataset = build_dataset_resident(robot, training_set_size=args.dataset_size,
                                                 only_non_self_colliding=only_nsc, device=device)
                dataset = dataclasses.replace(dataset, tags=tuple(args.dataset_tags))
            else:
                dataset = build_dataset(robot, training_set_size=args.dataset_size,
                                        only_non_self_colliding=only_nsc, device=device)
                dataset = dataclasses.replace(dataset, tags=tuple(args.dataset_tags))
                print(f"saved dataset to {save_dataset(dataset)}")

    config.ensure_cache_dirs()
    run_dir = args.run_dir or os.path.join(
        config.TRAINING_LOGS_DIR, f"{args.robot_name}__{time.strftime('%Y%m%d_%H%M%S')}"
    )
    ckpt_dir = os.path.join(run_dir, "checkpoints")

    flow = build_flow(hp, robot)
    params = flow.init(torch.Generator(device=device).manual_seed(cfg.seed))
    start_step = 0
    opt_state = None
    warm_start = None  # anneal provenance; survives --resume via config.json
    if args.resume:
        restored, start_step = restore_checkpoint(args.resume, device=device)
        params = restored["params"]
        opt_state = restored.get("opt_state")
        if opt_state is not None and opt_state.get("name") != cfg.optimizer:
            opt_state = None
        print(f"resumed from {args.resume} at step {start_step} "
              f"(opt_state {'restored' if opt_state is not None else 'reset'})")
    elif args.init_npz:
        params, deploy_header = load_deploy(args.init_npz, flow.param_shapes(), device)
        if deploy_header.get("robot_name") != robot.name:
            raise ValueError(
                f"deploy artifact is for robot {deploy_header.get('robot_name')!r}, not {robot.name!r}"
            )
        # Hyperparameters that leave the shapes alone must match too, or the
        # run would train another model than the artifact describes
        # (softflow_noise_scale may change: it only conditions training).
        artifact_hp = deploy_header.get("hyper_parameters", {})
        for field in ("sigmoid_on_output", "softflow_enabled", "rnvp_clamp", "clamp_activation"):
            want, got = getattr(hp, field), artifact_hp.get(field, getattr(hp, field))
            if got != want:
                raise ValueError(
                    f"--init_npz hyperparameter mismatch: artifact has {field}={got!r} but the CLI flags "
                    f"build {field}={want!r}. Match the flags to the artifact."
                )
        warm_start = {
            "from": os.path.basename(args.init_npz),
            "prior_steps": int(deploy_header.get("global_step") or 0),
        }
        print(f"warm-started from deploy artifact {args.init_npz} "
              f"(previously trained to step {deploy_header.get('global_step')}; "
              f"optimizer state fresh, step counter restarts at 0)")

    mesh = None
    if args.data_parallel:
        mesh = make_mesh() if device.type == "cuda" else make_mesh([device])
        print(f"data-parallel over {mesh.size} devices")

    os.makedirs(run_dir, exist_ok=True)
    ds_hash = _file_sha256(os.path.join(dataset_directory(args.robot_name, tuple(args.dataset_tags)), "dataset.npz"))
    # A --resume relaunch skips --init_npz: recover the provenance from the
    # config.json the first launch wrote.
    config_path = os.path.join(run_dir, "config.json")
    if warm_start is None and os.path.exists(config_path):
        try:
            with open(config_path) as f:
                warm_start = json.load(f).get("warm_start")
        except (OSError, ValueError):
            pass
    with open(config_path, "w") as f:
        json.dump(
            {"hyper_parameters": hp.to_dict(), "train_config": vars(args), "dataset_sha256": ds_hash,
             "dataset_sizes": {"train": int(dataset.n_train), "test": int(dataset.samples_te.shape[0])},
             "warm_start": warm_start},
            f, indent=2, default=str,
        )

    metric_hook = None
    if args.wandb:
        from ikflow_tpu_torch.training.wandb_compat import maybe_wandb_hook

        metric_hook = maybe_wandb_hook(args.wandb_project, os.path.basename(run_dir), {**hp.to_dict(), **vars(args)})
        if metric_hook is None:
            print("wandb requested but not installed; continuing with JSONL only")

    trainer = Trainer(flow, robot, cfg, log_dir=run_dir, metric_hook=metric_hook, device=device, mesh=mesh)
    try:
        t0 = time.time()
        if args.on_device_data:
            params, metrics = trainer.fit_on_device(
                params, dataset, checkpoint_dir=ckpt_dir, steps_per_call=args.steps_per_call,
                time_budget_s=args.time_budget_s, opt_state=opt_state, start_step=start_step,
            )
        else:
            params, metrics = trainer.fit(params, dataset, checkpoint_dir=ckpt_dir, start_step=start_step,
                                          opt_state=opt_state)
        dt = time.time() - t0
        # The step reached: a --time_budget_s run can stop before n_steps.
        end_step = int(metrics.get("step", start_step))
        steps_done = max(end_step - start_step, 0)
        if steps_done == 0:
            print(f"checkpoint already at/past n_steps ({start_step} >= {cfg.n_steps}); nothing to train")
        else:
            print(f"trained {steps_done} steps ({start_step} -> {end_step}) in {dt:.1f}s "
                  f"({steps_done / max(dt, 1e-9):.1f} steps/s); "
                  f"final tr/loss={metrics.get('tr/loss', float('nan')):.4f}; run dir: {run_dir}")

        if args.export:
            # Grade the final params so the header carries their own quality
            # (the last periodic eval can be eval_every steps old).
            val = trainer.validate(params, dataset, torch.Generator(device=device).manual_seed(cfg.seed + 7),
                                   end_step)
            quality = {
                "val_l2_error_mm": val.get("val/l2_error_mm", float("nan")),
                "val_angular_error_deg": val.get("val/angular_error_deg", float("nan")),
            }
            gate_mm, gate_source = resolve_export_gate(args.export, args.export_gate_mm)
            print(f"deploy gate: {gate_mm} mm ({gate_source})")
            ws = None
            if warm_start and warm_start.get("prior_steps"):
                ws = dict(warm_start, total_steps=end_step + int(warm_start["prior_steps"]))
            try:
                path = export_deploy(
                    args.export, params, hp, robot.name, global_step=end_step, dtype=args.export_dtype,
                    quality=quality, max_val_l2_mm=None if args.export_force else gate_mm, warm_start=ws,
                )
            except DeployQualityError as e:
                print(f"EXPORT REFUSED: {e}")
                return 1
            print(f"exported deploy artifact -> {path} (val l2 {quality['val_l2_error_mm']:.2f} mm)")
    finally:
        trainer.close()
    return 0
