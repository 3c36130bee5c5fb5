"""Checkpoint / resume.

Counterpart of :mod:`pyhgt_tpu.train.checkpoint`. The JAX package writes
its train state with orbax, which cannot be read without JAX; the port's
format is its own: one directory holding ``state.pt``, a ``torch.save`` of
``{"model": state dict, "optimizer": the optimizer's state dict or None,
"step": int}``. It loads with ``weights_only=True`` and strictly: a missing
or extra parameter, or one of another shape, raises.
:func:`pyhgt_tpu_torch.convert.checkpoint_from_flax` writes one from a JAX
parameter tree. The best-valid policy of the reference epoch loop
(``OAG/train_paper_field.py:270-280``) is :class:`BestCheckpointPolicy`.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import torch

from pyhgt_tpu_torch.train.step import TrainState

CHECKPOINT_FILE = "state.pt"


def write_checkpoint(path: str, model_state: Mapping[str, torch.Tensor],
                     optimizer_state: Optional[Mapping[str, Any]] = None,
                     step: int = 0) -> None:
    """Write the checkpoint directory ``path`` from state dicts (the file
    is replaced whole, never left half written)."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, CHECKPOINT_FILE)
    tmp = f"{out}.{os.getpid()}.tmp"
    torch.save({"model": dict(model_state), "optimizer": optimizer_state,
                "step": int(step)}, tmp)
    os.replace(tmp, out)


def save_checkpoint(path: str, state: TrainState, force: bool = True) -> None:
    """Save a :class:`~pyhgt_tpu_torch.train.step.TrainState` (model,
    optimizer, step) to the directory ``path``; ``force=False`` refuses to
    overwrite one. A state whose optimizer is None (a pipeline's model
    gathered on one rank, whose optimizer state is spread over the stages)
    is written with none."""
    if not force and os.path.exists(os.path.join(path, CHECKPOINT_FILE)):
        raise FileExistsError(f"{path} already holds a checkpoint")
    opt = state.optimizer
    write_checkpoint(path, state.model.state_dict(),
                     opt.inner.state_dict() if opt is not None else None,
                     state.step)


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore ``path`` into ``template`` (a freshly built TrainState of the
    same model and optimizer) and return it. The model loads strictly; the
    optimizer's state loads when the checkpoint has one (a checkpoint
    converted from JAX parameters has none: the optimizer stays fresh);
    the step count is set."""
    payload = torch.load(os.path.join(path, CHECKPOINT_FILE),
                         map_location="cpu", weights_only=True)
    template.model.load_state_dict(payload["model"], strict=True)
    if payload["optimizer"] is not None:
        template.optimizer.inner.load_state_dict(payload["optimizer"])
    template.optimizer.count = int(payload["step"])
    return template


class BestCheckpointPolicy:
    """Save-on-best-valid, mirroring the reference epoch loop
    (``OAG/train_paper_field.py:270-280``): call :meth:`update` with each
    epoch's validation score; the state is saved only when it improves."""

    def __init__(self, path: str, mode: str = "max") -> None:
        self.path = path
        self.mode = mode
        self.best: Optional[float] = None

    def update(self, score: float, state: TrainState) -> bool:
        better = (
            self.best is None
            or (self.mode == "max" and score > self.best)
            or (self.mode == "min" and score < self.best)
        )
        if better:
            self.best = float(score)
            save_checkpoint(self.path, state)
        return better
