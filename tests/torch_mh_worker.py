"""One rank of ``analysis.multihost_smoke`` for
``tests/test_torch_multihost.py``: runs the rank (``run_rank``, which joins
the gloo group at ``localhost:$IKFLOW_TPU_MH_PORT``) and saves its
parameters after the step and its loss to ``argv[2]``."""

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from ikflow_tpu_torch.analysis.multihost_smoke import run_rank  # noqa: E402
from ikflow_tpu_torch.training.common import tree_leaves  # noqa: E402

if __name__ == "__main__":
    params, loss, valids = run_rank(int(sys.argv[1]), "cpu")
    torch.save({"leaves": list(tree_leaves(params)), "loss": loss, "valids": valids}, sys.argv[2])
