"""Training: datasets, the maximum-likelihood loss, optimizers, the trainer,
checkpoints and the deploy export. Port of ``ikflow_tpu/training``."""

from ikflow_tpu_torch.training.dataset import (
    IkDataset,
    build_dataset,
    build_dataset_resident,
    load_dataset,
    save_dataset,
)
from ikflow_tpu_torch.training.loss import get_softflow_noise, make_loss_fn
from ikflow_tpu_torch.training.optimizers import make_optimizer
from ikflow_tpu_torch.training.trainer import TrainConfig, Trainer

__all__ = [
    "IkDataset",
    "build_dataset",
    "build_dataset_resident",
    "load_dataset",
    "save_dataset",
    "get_softflow_noise",
    "make_loss_fn",
    "make_optimizer",
    "TrainConfig",
    "Trainer",
]
