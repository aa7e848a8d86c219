"""``ikflow-torch`` CLI: the port's command line, one subcommand per task.

Port of ``ikflow_tpu/cli/main.py``; only ``train`` is ported so far.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ikflow-torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    from ikflow_tpu_torch.cli import train_cmd

    train_cmd.add_parser(sub)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
