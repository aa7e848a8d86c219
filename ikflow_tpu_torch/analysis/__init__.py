"""The analysis studies on the port: one module per script of the JAX
package's ``analysis/`` directory, under the same names, each with the
script's flags plus ``--device`` (default ``cuda``, which raises without a
card; ``cpu`` runs on the CPU), and the script's lines, table headers and
JSON keys:

- ``lm_convergence_analysis``: valid share and time over repeat counts x LM
  step budgets;
- ``inference_optimization``: the flow inverse per backend x batch size,
  fp32 or bf16 hidden layers;
- ``solution_refinement_runtime``: the flow alone, the card's LM and the
  float64 host LM over batch sizes;
- ``post_training_eval``: the battery on a deploy artifact;
- ``robot_visualizations``: solution-family renders and latent statistics;
- ``multihost_smoke``: two processes, a data-parallel step and an exact
  solve across them.

Run one with ``python -m ikflow_tpu_torch.analysis.<name> [flags]``.

Names. Where a flag value or an output key of a JAX script names a JAX
backend or the TPU, the port uses its own name (``RENAMES``): ``xla`` ->
``plain`` (the plain PyTorch subnets), ``pallas`` -> ``kernel`` (the CUDA
kernels K1 / K1'), ``tpu_lm`` -> ``gpu_lm`` (the batched LM on the device),
``pallas_vs_xla_numerics`` -> ``kernel_vs_plain_numerics``. The command
lines accept the JAX spellings as aliases.

Timing. On a card the solves replay the solver's captured graphs (the
default there, the counterpart of the JAX scripts' ``jit`` programs). A
key's first call runs eagerly and its second captures the graph, so every
timed solve follows ``graphs.WARMUP_CALLS`` untimed calls of its shape
(``warm_then_time``), where a JAX script makes one untimed call to compile.
Each timed call is ``cli.common.timed_call_s`` on the solver's device.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

RENAMES = {"xla": "plain", "pallas": "kernel", "tpu_lm": "gpu_lm",
           "pallas_vs_xla_numerics": "kernel_vs_plain_numerics"}
RENAME_HELP = ", ".join(f"{a} -> {b}" for a, b in RENAMES.items())


def renamed(name: str) -> str:
    """The port's name for ``name`` (a JAX spelling or the port's own)."""
    return RENAMES.get(name, name)


def warm_then_time(fn: Callable, device, k: int = 1) -> Tuple[List[float], list]:
    """``graphs.WARMUP_CALLS`` untimed calls ``fn(0)``, ``fn(1)``, then
    ``k`` timed ones, ``fn(WARMUP_CALLS)`` on (the index picks a call's
    draws). -> (the timed calls' seconds, their outputs)."""
    from ikflow_tpu_torch.cli.common import timed_call_s
    from ikflow_tpu_torch.graphs import WARMUP_CALLS

    for i in range(WARMUP_CALLS):
        fn(i)
    seconds, outputs = [], []
    for i in range(WARMUP_CALLS, WARMUP_CALLS + k):
        seconds.append(timed_call_s(lambda: outputs.append(fn(i)), device))
    return seconds, outputs
