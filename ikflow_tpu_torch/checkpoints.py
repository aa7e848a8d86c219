"""Reading the deploy ``.npz`` artifacts, and taking parameters from the JAX
package's pytree.

A deploy artifact holds a JSON header (``__header__``) and one array per
layer leaf, keyed ``<block>/s{1,2}/<layer>/{w,b}`` and stored in fp16 for the
shipped models. The arrays are read in place from the ``.npz`` and cast to
fp32; no converted copy is written anywhere.
"""

from __future__ import annotations

import json
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def read_deploy_header(path: str) -> Optional[Dict]:
    """Header dict of a deploy artifact, or None if unreadable or absent."""
    try:
        with np.load(path) as z:
            return json.loads(bytes(z["__header__"]).decode())
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.asarray(arr, dtype=np.float32), device=device)


def load_deploy(path: str, param_shapes, device="cuda") -> Tuple[Any, Dict]:
    """Load a deploy artifact into the structure of ``param_shapes`` (from
    ``GlowFlow.param_shapes``), checking every leaf's shape. Returns
    (params, header)."""
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
