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
from typing import Any, Dict, Mapping, Optional

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
    overwrite one. A parallel run saves the whole model and optimizer
    gathered on its first rank (``experiments.engine``), so every
    checkpoint loads in a single process."""
    if not force and os.path.exists(os.path.join(path, CHECKPOINT_FILE)):
        raise FileExistsError(f"{path} already holds a checkpoint")
    write_checkpoint(path, state.model.state_dict(),
                     state.optimizer.inner.state_dict(), state.step)


def named_optimizer_state(optimizer, named) -> Dict[str, Dict[str, Any]]:
    """The per-parameter state of ``optimizer`` (AdamW: ``exp_avg``,
    ``exp_avg_sq``, ``step``) keyed by parameter name, over ``named``
    (``named_parameters()`` pairs of the parameters it updates): the form
    in which a model spread over ranks moves its moments."""
    state = optimizer.inner.state
    return {n: state[p] for n, p in named if p in state}


def load_named_optimizer_state(optimizer, named,
                               by_name: Mapping[str, Mapping[str, Any]]
                               ) -> None:
    """Set the state of every parameter of ``named`` that ``by_name``
    holds (:func:`named_optimizer_state`'s form) into ``optimizer``, the
    moments copied onto the parameter's device; a per-tensor ``step``
    stays where the optimizer keeps it (on the host). A tensor the
    optimizer already holds in the same shape is copied into, so the
    flat buffers of ``FlatAdamW`` (``fused_opt``), whose per-parameter
    state is views into them, stay whole."""
    for n, p in named:
        if n not in by_name:
            continue
        new = {k: (v.to(p.device, copy=True) if torch.is_tensor(v)
                   and v.dim() else v.clone() if torch.is_tensor(v) else v)
               for k, v in by_name[n].items()}
        held = optimizer.inner.state.get(p)
        if not held:
            optimizer.inner.state[p] = new
            continue
        for k, v in new.items():
            old = held.get(k)
            if torch.is_tensor(old) and torch.is_tensor(v) \
                    and old.shape == v.shape:
                old.copy_(v)
            else:
                held[k] = v


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore ``path`` into ``template`` (a freshly built TrainState of the
    same model and optimizer) and return it. The model loads strictly; the
    optimizer's state loads when the checkpoint has one (a checkpoint
    converted from JAX parameters has none: the optimizer stays fresh);
    the step count is set. A parallel run restores its whole state here
    and then hands each rank its part (``experiments.engine``)."""
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
