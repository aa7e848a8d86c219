"""PyTorch and CUDA port of ikflow_tpu: conditional normalizing-flow IK with
batched Levenberg-Marquardt refinement, for NVIDIA Hopper GPUs.

Entry point: ``registry.get_ik_solver(name)`` -> ``IKFlowSolver``
(``generate_ik_solutions``, ``generate_exact_ik_solutions``). Everything runs
on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

_LAZY = {
    "IKFlowSolver": "ikflow_tpu_torch.solver",
    "FlowHyperParams": "ikflow_tpu_torch.flow",
    "get_robot": "ikflow_tpu_torch.robots",
    "get_ik_solver": "ikflow_tpu_torch.registry",
    "get_all_model_names": "ikflow_tpu_torch.registry",
}


def __getattr__(name):
    """The top-level names, imported on first use so ``import
    ikflow_tpu_torch`` stays light."""
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(_LAZY[name]), name)
