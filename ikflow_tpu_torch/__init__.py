"""PyTorch and CUDA port of ikflow_tpu: conditional normalizing-flow IK with
batched Levenberg-Marquardt refinement, for NVIDIA Hopper GPUs.

Entry point: ``registry.get_ik_solver(name)`` -> ``IKFlowSolver``
(``generate_ik_solutions``, ``generate_exact_ik_solutions``). Everything runs
on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""
