"""Training checkpoints, the deploy artifact, and its quality gate.

Port of ``ikflow_tpu/training/checkpoints.py``.

- Checkpoints: ``{directory}/{step}/checkpoint.pt``, one ``torch.save`` of
  ``{"params": ..., "opt_state": ...}`` per step, the newest ``keep`` kept.
  The JAX package writes orbax checkpoints; the two formats are not shared.
- The deploy artifact, which the registry serves, is one ``.npz``: a JSON
  header (``__header__``, with the hyperparameters, the robot, and where
  known the quality, the gate it passed, the warm-start provenance and the
  stored dtype) and one array per layer leaf, keyed ``<block>/s{1,2}/<layer>/
  {w,b}``. Both packages write and read the same artifact.
- The export gate: an export is refused when its validation error is missing,
  not finite, or above the gate; the gate comes from the caller, else from the
  registry's ``export_gate_mm`` for the artifact's basename, else 100 mm, and
  an existing artifact at the target path bounds it by the incumbent rule.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ikflow_tpu_torch.flow.params import FlowHyperParams

CHECKPOINT_FILE = "checkpoint.pt"
# An export of statistically equal quality to the artifact it replaces (the
# end-of-run export after a periodic one of the same weights) is not refused
# over validation noise.
INCUMBENT_TOLERANCE_MM = 0.25
DEFAULT_GATE_MM = 100.0


# ---------------------------------------------------------------------------
# Training checkpoints.
# ---------------------------------------------------------------------------


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(os.path.join(directory, d, CHECKPOINT_FILE)))


def save_checkpoint(directory: str, step: int, params, opt_state=None, keep: int = 3) -> str:
    """Write step ``step``'s checkpoint and delete all but the newest ``keep``.
    Returns the step's directory."""
    directory = os.path.abspath(directory)
    step_dir = os.path.join(directory, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    payload = {"params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    tmp = os.path.join(step_dir, CHECKPOINT_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(step_dir, CHECKPOINT_FILE))
    for old in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return step_dir


def latest_checkpoint_step(directory: str) -> Optional[int]:
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None, device="cpu") -> Tuple[Dict, int]:
    """(``{"params"[, "opt_state"]}``, step) of ``step``, default the newest,
    with its tensors on ``device``."""
    directory = os.path.abspath(directory)
    step = latest_checkpoint_step(directory) if step is None else int(step)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, str(step), CHECKPOINT_FILE)
    return torch.load(path, map_location=device, weights_only=True), step


# ---------------------------------------------------------------------------
# Deploy artifact.
# ---------------------------------------------------------------------------


class DeployQualityError(ValueError):
    """An export failed the quality gate: diverged or unconverged weights
    never ship silently."""


def read_deploy_header(path: str) -> Optional[Dict]:
    """Header dict of a deploy artifact, or None if unreadable or absent."""
    try:
        with np.load(path) as z:
            return json.loads(bytes(z["__header__"]).decode())
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None


def registry_gate_mm(artifact_path: str) -> Optional[float]:
    """The registry's ``export_gate_mm`` of the entry whose ``weights_path``
    has the artifact's basename, or None when no entry ships it."""
    from ikflow_tpu_torch.registry import model_descriptions

    base = os.path.basename(artifact_path)
    if not base.endswith(".npz"):
        base += ".npz"
    for entry in model_descriptions().values():
        wp = entry.get("weights_path")
        if wp and os.path.basename(wp) == base and "export_gate_mm" in entry:
            return float(entry["export_gate_mm"])
    return None


def resolve_export_gate(artifact_path: str, policy_gate_mm: Optional[float] = None) -> Tuple[float, str]:
    """(gate in mm, where it came from) for an export to ``artifact_path``.

    The base is ``policy_gate_mm``, else the registry's gate for the
    artifact, else 100 mm. When an artifact with a finite quality ``v``
    already exists at the path, the gate is ``max(v, min(base, v +
    INCUMBENT_TOLERANCE_MM))``: an export ships when it improves on the
    incumbent, or meets the base without regressing the incumbent beyond
    validation noise."""
    base = policy_gate_mm
    source = f"explicit {base}" if base is not None else None
    if base is None:
        base = registry_gate_mm(artifact_path)
        source = f"registry {base}" if base is not None else None
    if base is None:
        base, source = DEFAULT_GATE_MM, f"default backstop {DEFAULT_GATE_MM}"
    header = read_deploy_header(artifact_path) if os.path.exists(artifact_path) else None
    incumbent = (header or {}).get("quality", {}).get("val_l2_error_mm")
    if incumbent is not None and np.isfinite(incumbent):
        v = float(incumbent)
        bound = max(v, min(base, v + INCUMBENT_TOLERANCE_MM))
        if bound != base:
            return bound, f"{source}; incumbent rule (shipped val {v:.2f}, tolerance {INCUMBENT_TOLERANCE_MM})"
    return base, source


def flatten_params(params) -> Dict[str, np.ndarray]:
    """``{"<block>/<s1|s2>/<layer>/<w|b>": array}`` of the flow's parameters."""
    return {
        f"{i}/{s}/{j}/{k}": layer[k].detach().cpu().numpy()
        for i, block in enumerate(params) for s in ("s1", "s2") for j, layer in enumerate(block[s])
        for k in ("w", "b")
    }


def export_deploy(
    path: str,
    params,
    hyper_parameters: FlowHyperParams,
    robot_name: str,
    global_step: Optional[int] = None,
    dtype: Optional[str] = None,
    quality: Optional[Dict[str, float]] = None,
    max_val_l2_mm: Optional[float] = None,
    warm_start: Optional[Dict] = None,
) -> str:
    """Write the deploy artifact; returns the path written (``.npz`` added
    when missing).

    ``dtype`` (e.g. "float16") is the storage dtype of the leaves, recorded
    in the header; ``load_deploy`` casts them back to fp32. ``quality`` (e.g.
    ``{"val_l2_error_mm": 8.1}``) goes into the header with the gate; with
    ``max_val_l2_mm`` the export raises :class:`DeployQualityError` when
    ``val_l2_error_mm`` is missing, not finite or above it. ``warm_start``
    (``{"from": ..., "prior_steps": ..., "total_steps": ...}``) records the
    training that came before this run's ``global_step`` steps."""
    if max_val_l2_mm is not None:
        v = None if quality is None else quality.get("val_l2_error_mm")
        if v is None or not np.isfinite(v) or v > max_val_l2_mm:
            raise DeployQualityError(
                f"refusing deploy export to {path!r}: val_l2_error_mm={v} fails the quality gate "
                f"(max {max_val_l2_mm} mm). Pass max_val_l2_mm=None / --export_force to ship anyway."
            )
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = {
        "format_version": 1,
        "robot_name": robot_name,
        "global_step": global_step,
        "hyper_parameters": hyper_parameters.to_dict(),
        "stored_dtype": dtype or "native",
    }
    if quality is not None:
        header["quality"] = {k: (v if isinstance(v, str) else float(v)) for k, v in quality.items()}
        header["quality_gate_mm"] = max_val_l2_mm
    if warm_start is not None:
        header["warm_start"] = {k: (v if isinstance(v, str) else int(v)) for k, v in warm_start.items()}
    flat = flatten_params(params)
    if dtype is not None:
        flat = {k: v.astype(dtype) for k, v in flat.items()}
    np.savez_compressed(path, __header__=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8), **flat)
    return path


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """fp32 and in row-major order: some shipped artifacts store a layer's
    weight in column-major order, which ``torch.tensor`` would keep as
    strides, and the kernels read only contiguous tensors."""
    return torch.tensor(np.ascontiguousarray(arr, dtype=np.float32), device=device)


def load_deploy(path: str, param_shapes, device="cuda") -> Tuple[Any, Dict]:
    """Load a deploy artifact into the structure of ``param_shapes`` (from
    ``GlowFlow.param_shapes``), checking every leaf's shape; the leaves are
    read in place from the ``.npz`` and cast to fp32. Returns (params,
    header)."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        files = set(z.files)

        def leaf(key, shape):
            if key not in files:
                raise ValueError(f"missing parameter {key!r} in {path}")
            arr = z[key]
            if arr.shape != tuple(shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(shape)}")
            return _to_tensor(arr, device)

        params = tuple(
            {
                s: [{k: leaf(f"{i}/{s}/{j}/{k}", layer[k]) for k in ("w", "b")} for j, layer in enumerate(block[s])]
                for s in ("s1", "s2")
            }
            for i, block in enumerate(param_shapes)
        )
    return params, header


def params_from_jax(params_np, device="cpu"):
    """The JAX package's flow parameters (its pytree with numpy leaves) as the
    port's parameters. Both use the same structure."""
    return tuple(
        {s: [{k: _to_tensor(layer[k], device) for k in ("w", "b")} for layer in block[s]] for s in ("s1", "s2")}
        for block in params_np
    )
