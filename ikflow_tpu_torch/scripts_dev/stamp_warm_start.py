"""Add warm-start provenance to an already-exported deploy artifact.

Port of ``scripts_dev/stamp_warm_start.py``. The trainer records
``header['warm_start']`` itself (``train --init_npz`` -> ``export_deploy``'s
``warm_start``); an artifact exported without it gets the same provenance
here: the arrays untouched, the JSON header grows a ``warm_start`` entry with
``total_steps = global_step + prior_steps`` and a note that the stamp was
post-hoc. An artifact that has one already is left alone. It runs no flow.

Usage: python -m ikflow_tpu_torch.scripts_dev.stamp_warm_start <artifact.npz> <from_name> <prior_steps>
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ikflow_tpu_torch.training.checkpoints import read_artifact, write_artifact

STAMP = "post-hoc (ikflow_tpu_torch.scripts_dev.stamp_warm_start)"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("from_name")
    ap.add_argument("prior_steps", type=int)
    args = ap.parse_args(argv)
    path, prior = args.path, args.prior_steps
    header, arrays = read_artifact(path)
    if "warm_start" in header:
        print(f"{path}: warm_start already present ({header['warm_start']}); not touching")
        return 0
    gs = int(header.get("global_step") or 0)
    header["warm_start"] = {"from": args.from_name, "prior_steps": prior, "total_steps": gs + prior, "stamp": STAMP}
    write_artifact(path, header, arrays)
    print(f"{path}: stamped warm_start {header['warm_start']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
