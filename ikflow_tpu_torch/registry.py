"""Model registry: model name -> (solver, hyperparameters), weights loaded.

Port of ``ikflow_tpu/registry.py``. The port keeps its own copy of
``model_descriptions.yaml`` (a test pins it equal to the JAX package's) and
reads it with a small parser of its own, so it needs no YAML package: the
file is a map of model names to flat maps of scalars.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from ikflow_tpu_torch import config
from ikflow_tpu_torch.training.checkpoints import load_deploy
from ikflow_tpu_torch.flow.model import build_flow
from ikflow_tpu_torch.flow.params import FlowHyperParams
from ikflow_tpu_torch.robots import get_robot
from ikflow_tpu_torch.solver import IKFlowSolver

DESCRIPTIONS_PATH = os.path.join(os.path.dirname(__file__), "model_descriptions.yaml")


def _scalar(text: str):
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in ("true", "false"):
        return text == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_descriptions(text: str) -> Dict[str, Dict]:
    """Parse ``name:`` lines, each followed by indented ``key: value`` lines
    of scalars; ``#`` starts a comment."""
    out: Dict[str, Dict] = {}
    entry = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        if not line[0].isspace():
            if not line.endswith(":"):
                raise ValueError(f"{DESCRIPTIONS_PATH}:{lineno}: expected 'name:', got {raw!r}")
            entry = out[line[:-1].strip()] = {}
        else:
            key, sep, value = line.strip().partition(":")
            if entry is None or not sep:
                raise ValueError(f"{DESCRIPTIONS_PATH}:{lineno}: expected '  key: value', got {raw!r}")
            entry[key.strip()] = _scalar(value.strip())
    return out


def model_descriptions() -> Dict[str, Dict]:
    with open(DESCRIPTIONS_PATH) as f:
        return parse_descriptions(f.read())


def resolve_weights_path(entry: Dict) -> Optional[str]:
    """Absolute path of an entry's weights: absolute, ``file://``, or relative
    to the first of ``config.MODELS_DIR`` (the user cache) and
    ``config.REPO_MODELS_DIR`` that holds it, else to the cache. Both are read
    at call time, so a cache redirected after import is honored."""
    wp = entry.get("weights_path")
    if wp is None:
        return None
    if wp.startswith("file://"):
        wp = wp[len("file://") :]
    if os.path.isabs(wp):
        return wp
    candidates = [os.path.join(d, wp) for d in (config.MODELS_DIR, config.REPO_MODELS_DIR)]
    return next((c for c in candidates if os.path.exists(c)), candidates[0])


def get_ik_solver(
    model_name: str, allow_uninitialized: bool = False, device="cuda"
) -> Tuple[IKFlowSolver, FlowHyperParams]:
    """Build the solver of a registered model on ``device`` and load its
    weights. Returns (solver, hyper_parameters)."""
    descriptions = model_descriptions()
    if model_name not in descriptions:
        raise ValueError(f"unknown model {model_name!r}; available: {list(descriptions)}")
    entry = descriptions[model_name]
    hp = FlowHyperParams.from_dict(entry)
    robot = get_robot(entry["robot_name"])
    device = config.resolve_device(device)

    weights = resolve_weights_path(entry)
    if weights is not None and os.path.exists(weights):
        params, header = load_deploy(weights, build_flow(hp, robot).param_shapes(), device)
        if header["robot_name"] != robot.name:
            raise ValueError(f"weights are for {header['robot_name']}, registry says {robot.name}")
        return IKFlowSolver(hp, robot, params=params, device=device), hp
    if not allow_uninitialized:
        raise FileNotFoundError(
            f"weights for {model_name!r} not found at {weights!r}; pass allow_uninitialized=True "
            "to build the solver with random weights"
        )
    return IKFlowSolver(hp, robot, device=device), hp
