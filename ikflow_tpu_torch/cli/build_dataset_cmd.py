"""``ikflow-torch build-dataset``: an IK dataset drawn on the device.

Port of ``ikflow_tpu/cli/build_dataset_cmd.py``, same flags
(``--only_non_self_colliding`` is on unless ``--all_configs`` is given),
over ``training.build_dataset`` and ``save_dataset``; ``--device`` (default
``cuda``) picks the device.
"""

from __future__ import annotations

import argparse
import time

from ikflow_tpu_torch.cli.common import add_device_argument


def add_parser(sub):
    p = sub.add_parser("build-dataset", help="generate an IK dataset on-device")
    p.add_argument("--robot_name", type=str, required=True)
    p.add_argument("--training_set_size", type=int, default=2_500_000)
    p.add_argument("--test_set_size", type=int, default=15_000)
    p.add_argument("--only_non_self_colliding", action="store_true", default=True)
    p.add_argument("--all_configs", dest="only_non_self_colliding", action="store_false",
                   help="keep self-colliding configs too")
    p.add_argument("--joint_limit_eps", type=float, default=0.004363)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_dir", type=str, default=None)
    add_device_argument(p)
    p.set_defaults(func=run)
    return p


def run(args: argparse.Namespace) -> int:
    from ikflow_tpu_torch.robots import get_robot
    from ikflow_tpu_torch.training import build_dataset, save_dataset

    robot = get_robot(args.robot_name)
    t0 = time.time()
    ds = build_dataset(
        robot,
        training_set_size=args.training_set_size,
        test_set_size=args.test_set_size,
        only_non_self_colliding=args.only_non_self_colliding,
        joint_limit_eps=args.joint_limit_eps,
        seed=args.seed,
        device=args.device,
    )
    directory = save_dataset(ds, args.output_dir)
    dt = time.time() - t0
    print(f"built {ds.n_train} train / {ds.samples_te.shape[0]} test samples for "
          f"{args.robot_name} in {dt:.1f}s -> {directory}")
    return 0
