"""Losses, the train and eval steps, optimizers and schedules, the
prefetch pipeline, checkpoints and the ranking metrics (counterpart of
:mod:`pyhgt_tpu.train`)."""

from pyhgt_tpu_torch.train.loader import PrefetchLoader
from pyhgt_tpu_torch.train.optim import (
    cosine_schedule,
    make_optimizer,
    onecycle_schedule,
)
from pyhgt_tpu_torch.train.step import (
    TrainState,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "make_optimizer",
    "cosine_schedule",
    "onecycle_schedule",
    "TrainState",
    "make_train_step",
    "make_eval_step",
    "PrefetchLoader",
]
