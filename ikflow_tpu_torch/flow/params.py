"""Flow hyperparameters: own copy of ``ikflow_tpu/flow/params.py`` (same
field names and defaults, so registry entries hydrate identically)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class FlowHyperParams:
    coupling_layer: str = "glow"
    nb_nodes: int = 12
    dim_latent_space: int = 9
    coeff_fn_config: int = 3  # subnet depth (number of hidden LeakyReLU layers)
    coeff_fn_internal_size: int = 1024  # subnet width
    permute_random_enabled: bool = True
    sigmoid_on_output: bool = False

    lambd_predict: float = 1.0
    init_scale: float = 0.04473500291638653
    rnvp_clamp: float = 2.5
    y_noise_scale: float = 1e-7
    zeros_noise_scale: float = 1e-3

    softflow_noise_scale: float = 0.01
    softflow_enabled: bool = True

    # "atan": s -> clamp * (2/pi) * atan(s); "atan_scaled": clamp * (2/pi) * atan(s / clamp).
    clamp_activation: str = "atan"
    # bf16 inputs and weights, fp32 accumulation, on the hidden x hidden
    # subnet matmuls (kernel K1' in the flow's inverse).
    bf16_hidden: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FlowHyperParams":
        """Hydrate from a registry entry, ignoring unknown keys."""
        hp = cls()
        known = {f.name for f in dataclasses.fields(cls)}
        for k, v in d.items():
            if k in known:
                setattr(hp, k, v)
        return hp

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def tiny_model_params() -> FlowHyperParams:
    """Small flow for fast tests: 3 blocks, subnets of depth 2 and width 256."""
    hp = FlowHyperParams()
    hp.nb_nodes = 3
    hp.coeff_fn_config = 2
    hp.coeff_fn_internal_size = 256
    return hp
