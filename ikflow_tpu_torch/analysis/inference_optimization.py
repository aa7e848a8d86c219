"""Inference-optimization study: backend x batch-size runtime matrix.

Port of ``analysis/inference_optimization.py`` (the reference's
``notebooks/inference_optimization.ipynb``, a torch.compile configuration
study): the knobs are the flow inverse's backend, the batch size and bf16
hidden matmuls, on panda's default architecture (D = 7) with random weights
from seed 0. Prints one JSON row per cell, ``{backend, batch, bf16,
ms_per_pass, samples_per_s}``.

Backends (``--backends``; the JAX names ``xla`` and ``pallas`` are
aliases of ``plain`` and ``kernel``):
- ``plain``: ``GlowFlow.inverse_plain``, every subnet through its plain
  PyTorch version (addmm + leaky_relu; with ``--bf16`` the bf16-rounded
  operands, fp32 sums);
- ``kernel``: ``GlowFlow.inverse`` on ``kernel_params``, every subnet
  through K1 (``csrc/fused_mlp.cu``), or K1' (``csrc/fused_mlp_bf16.cu``)
  with ``--bf16``. It runs only on a card: on the CPU the row is an error
  row, since the wrapper would run the plain version there.

Timing, as in the JAX script: a chain of dependent passes (each pass's input
takes a value-neutral ``+ acc * 1e-30`` from the passes before, so none can
be skipped), two chain lengths, their difference per pass
(``utils.profiling.measure_per_iter_s``, which refuses a difference inside
the noise). On a card each chain is one captured CUDA graph, replayed and
waited for; on the CPU it runs eagerly. On a card nothing is caught: a
kernel that fails raises and the study exits non-zero. On the CPU an error
becomes an error row, as in the JAX script.

Run on the card: python -m ikflow_tpu_torch.analysis.inference_optimization [--bf16]
"""

from __future__ import annotations

import argparse
import json
from typing import Callable

import torch

KERNEL_CPU_ERROR = "the kernel runs only on a CUDA device"
BACKENDS = ("plain", "kernel")


def backend_name(name: str) -> str:
    """``--backends`` values: the port's names or the JAX aliases."""
    from ikflow_tpu_torch.analysis import renamed

    if renamed(name) not in BACKENDS:
        raise argparse.ArgumentTypeError(f"unknown backend {name!r}: {', '.join(BACKENDS)} (or xla, pallas)")
    return renamed(name)


def study_flow(bf16: bool, device):
    """(flow, params): panda's default architecture with D = 7, random
    weights from seed 0 on ``device``."""
    from ikflow_tpu_torch.config import disable_tf32
    from ikflow_tpu_torch.flow import FlowHyperParams, build_flow
    from ikflow_tpu_torch.robots import get_robot

    disable_tf32()  # the plain versions' fp32 sums, as the solver runs them
    hp = FlowHyperParams()
    hp.dim_latent_space = 7
    hp.bf16_hidden = bf16
    flow = build_flow(hp, get_robot("panda"))
    return flow, flow.init(torch.Generator(device=device).manual_seed(0))


def pass_fn(flow, params, backend: str) -> Callable:
    """``fn(z, cond) -> q`` of one flow inverse on ``backend``."""
    if backend == "plain":
        return lambda z, cond: flow.inverse_plain(params, z, cond)[0]
    kernel_params = flow.kernel_params(params)
    return lambda z, cond: flow.inverse(kernel_params, z, cond)[0]


def chain_build(fn: Callable, z: torch.Tensor, cond: torch.Tensor):
    """``build(iters)`` for ``measure_per_iter_s``: ``iters`` dependent
    passes of ``fn``, one captured graph per chain on a card."""
    from ikflow_tpu_torch.graphs import CudaBackend

    def chain(iters):
        acc = torch.zeros((), device=z.device)
        for _ in range(iters):
            acc = acc + fn(z + acc * 1e-30, cond).sum() * 1e-30
        return acc

    def build(iters):
        if z.device.type != "cuda":
            return lambda i: float(chain(iters))
        chain(1)  # eagerly first: loads the kernels' libraries and uploads the flow's constants
        backend = CudaBackend(z.device)
        graph, _ = backend.capture(lambda: chain(iters), ())

        def run(i):
            backend.replay(graph)
            torch.cuda.synchronize(z.device)

        return run

    return build


def per_pass_s(flow, params, backend: str, z: torch.Tensor, cond: torch.Tensor, iters: int) -> float:
    """Seconds per flow inverse of ``z`` (B, D) at ``cond`` on ``backend``."""
    from ikflow_tpu_torch.utils import profiling

    return profiling.measure_per_iter_s(chain_build(pass_fn(flow, params, backend), z, cond),
                                        f"{backend} inverse, B={z.shape[0]}", k_deltas=(iters, 4 * iters))


def study_row(flow, params, backend: str, z: torch.Tensor, cond: torch.Tensor, iters: int, bf16: bool) -> dict:
    """One cell's JSON row. On a card an error raises; on the CPU it is an
    error row, and the kernel's row is always one there."""
    B = z.shape[0]
    if z.device.type != "cuda":
        if backend == "kernel":
            return {"backend": backend, "batch": B, "error": KERNEL_CPU_ERROR}
        try:
            per = per_pass_s(flow, params, backend, z, cond, iters)
        except Exception as e:  # as the JAX script reports a backend that cannot run
            return {"backend": backend, "batch": B, "error": str(e)[:120]}
    else:
        per = per_pass_s(flow, params, backend, z, cond, iters)
    return {"backend": backend, "batch": B, "bf16": bf16, "ms_per_pass": round(1000 * per, 3),
            "samples_per_s": round(B / per, 0)}


def main(argv=None) -> int:
    from ikflow_tpu_torch.analysis import RENAME_HELP
    from ikflow_tpu_torch.cli.common import add_device_argument
    from ikflow_tpu_torch.config import resolve_device

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
                                     epilog=f"JAX names accepted: {RENAME_HELP}")
    parser.add_argument("--batch_sizes", type=int, nargs="*", default=[512, 2048, 8192, 32768])
    parser.add_argument("--backends", type=backend_name, nargs="*", default=list(BACKENDS),
                        help="plain (alias xla) and/or kernel (alias pallas)")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--iters", type=int, default=8)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    flow, params = study_flow(args.bf16, device)
    for B in args.batch_sizes:
        z = torch.randn((B, flow.D), generator=torch.Generator(device=device).manual_seed(1), device=device)
        cond = torch.zeros((B, flow.dim_cond), device=device)
        for backend in args.backends:
            print(json.dumps(study_row(flow, params, backend, z, cond, args.iters, args.bf16)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
