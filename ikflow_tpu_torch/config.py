"""Configuration of the PyTorch port: the cache tree (models, datasets,
training logs), the dataset tags, the sigmoid-head scaling bound, and the
device rule.

Own copy of what the port needs from ``ikflow_tpu/config.py``; the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import os

import torch

# Cache tree, same layout and environment variable as the JAX package so that
# both find the same user-trained weights.
CACHE_DIR = os.environ.get(
    "IKFLOW_TPU_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache", "ikflow_tpu")
)
MODELS_DIR = os.path.join(CACHE_DIR, "models")
DATASET_DIR = os.path.join(CACHE_DIR, "datasets")
TRAINING_LOGS_DIR = os.path.join(CACHE_DIR, "training_logs")

# Repo-shipped deploy artifacts (<repo>/models), searched after the user cache.
# The registry reads both attributes when it resolves a path, so reassigning
# them after import redirects it; the dataset and training code read
# DATASET_DIR and TRAINING_LOGS_DIR the same way.
REPO_MODELS_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "models"))

# Dataset tags (a dataset directory is named by its robot and its tags).
DATASET_TAG_NON_SELF_COLLIDING = "non-self-colliding"
ALL_DATASET_TAGS = [DATASET_TAG_NON_SELF_COLLIDING]

# Scaling bound for the padding dims ahead of the sigmoid head.
SIGMOID_SCALING_ABS_MAX = 1.0


def ensure_cache_dirs() -> None:
    """Create the cache tree, as the module's attributes name it now."""
    for d in (CACHE_DIR, DATASET_DIR, MODELS_DIR, TRAINING_LOGS_DIR):
        os.makedirs(d, exist_ok=True)


def resolve_device(device="cuda") -> torch.device:
    """The device the caller asked for. A CUDA device without a card raises:
    the port never moves to the CPU unless asked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def disable_tf32() -> None:
    """Kinematics and the LM normal equations need true fp32 matmuls: TF32
    rounding in the rotation chain costs most of the 1 mm / 0.01 rad budget."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
