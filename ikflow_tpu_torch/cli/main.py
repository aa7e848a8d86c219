"""``ikflow-torch`` CLI: the port's command line, one subcommand per task.

Port of ``ikflow_tpu/cli/main.py``: ``build-dataset``, ``train``,
``evaluate``, ``solve``, ``benchmark`` and ``visualize``, each with the JAX
flags plus ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ikflow-torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    from ikflow_tpu_torch.cli import (
        bench_cmd,
        build_dataset_cmd,
        evaluate_cmd,
        solve_cmd,
        train_cmd,
        visualize_cmd,
    )

    build_dataset_cmd.add_parser(sub)
    train_cmd.add_parser(sub)
    evaluate_cmd.add_parser(sub)
    solve_cmd.add_parser(sub)
    bench_cmd.add_parser(sub)
    visualize_cmd.add_parser(sub)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
