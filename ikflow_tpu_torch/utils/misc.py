"""Small utilities. Port of ``ikflow_tpu/utils/misc.py``; ``set_seed`` also
seeds torch's generators (the port's solvers and trainers draw from their own
generators, seeded explicitly)."""

from __future__ import annotations

import os
import random
from typing import Dict

import numpy as np
import torch


def set_seed(seed: int = 0) -> None:
    """Seed numpy, python, torch (CPU and every card) and PYTHONHASHSEED."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def boolean_string(s) -> bool:
    """argparse-friendly bool parser."""
    if isinstance(s, bool):
        return s
    if str(s) not in ("True", "False", "true", "false", "1", "0"):
        raise ValueError(f"{s} is not a valid boolean string")
    return str(s) in ("True", "true", "1")


def safe_mkdir(directory: str) -> None:
    """mkdir -p."""
    os.makedirs(directory, exist_ok=True)


def tensor_stats(arr, name: str = "tensor") -> Dict[str, float]:
    """Summary statistics of an array or tensor (read on the host)."""
    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return {
        "name": name,
        "shape": tuple(a.shape),
        "dtype": str(a.dtype),
        "min": float(a.min()),
        "max": float(a.max()),
        "mean": float(a.mean()),
        "std": float(a.std()),
        "n_nan": int(np.isnan(a).sum()),
    }
