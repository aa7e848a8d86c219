from ikflow_tpu_torch.flow.fused_subnet import (
    fused_mlp,
    fused_mlp_bf16,
    fused_mlp_bf16_plain,
    fused_mlp_plain,
    prepare_bf16_subnet,
    prepare_tf32x3_subnet,
)
from ikflow_tpu_torch.flow.model import GlowFlow, build_flow
from ikflow_tpu_torch.flow.params import FlowHyperParams, tiny_model_params

__all__ = [
    "FlowHyperParams",
    "GlowFlow",
    "build_flow",
    "fused_mlp",
    "fused_mlp_bf16",
    "fused_mlp_bf16_plain",
    "fused_mlp_plain",
    "prepare_bf16_subnet",
    "prepare_tf32x3_subnet",
    "tiny_model_params",
]
