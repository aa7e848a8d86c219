"""Optional wandb metric hook.

Port of ``ikflow_tpu/training/wandb_compat.py``: the trainer always writes
``metrics.jsonl``; wandb is attached only when the library is importable and
the caller asks for it, as ``Trainer(metric_hook=...)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


def maybe_wandb_hook(project: str, run_name: Optional[str], config: Dict) -> Optional[Callable[[int, Dict], None]]:
    """A ``(step, metrics) -> None`` hook, or None when wandb is absent."""
    try:
        import wandb
    except ImportError:
        return None

    run = wandb.init(project=project, name=run_name, config=config)

    def hook(step: int, metrics: Dict) -> None:
        run.log({k: v for k, v in metrics.items() if k != "step"}, step=step)

    return hook
