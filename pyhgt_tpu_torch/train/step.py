"""Losses and the eager train step.

Counterpart of :mod:`pyhgt_tpu.train.step` (``nll_loss``, ``kl_div_loss``,
``TrainState``, ``make_train_step``, ``make_eval_step``): the reference
epoch-loop body, forward → loss → backward → clip → optimizer step →
scheduler (``OAG/train_paper_field.py:240-256``). The JAX package traces it
into one XLA program over a functional state; here the model and the
optimizer hold their own state and the step runs eagerly.
:func:`make_train_step_acc` is the gradient-accumulation variant.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from pyhgt_tpu_torch.train.optim import ScheduledOptimizer


def kl_div_loss(log_probs, soft_targets, mask=None):
    """KLDivLoss(reduction='batchmean') semantics: sum over classes of
    t * (log t - log p), averaged over batch rows. Rows with all-zero
    targets contribute 0 (the reference normalizes labels to sum 1).
    ``mask [rows]`` weighs the rows and replaces the row count."""
    t = soft_targets
    safe_log_t = torch.where(t > 0, torch.log(torch.clamp(t, min=1e-30)),
                             torch.zeros_like(t))
    per_row = (t * (safe_log_t - log_probs)).sum(dim=-1)
    if mask is not None:
        mask = mask.to(per_row.dtype)
        return (per_row * mask).sum() / torch.clamp(mask.sum(), min=1)
    return per_row.mean()


def nll_loss(log_probs, labels, mask=None):
    """NLLLoss on log-probabilities; ``mask [rows]`` as in
    :func:`kl_div_loss`."""
    per_row = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    if mask is not None:
        mask = mask.to(per_row.dtype)
        return (per_row * mask).sum() / torch.clamp(mask.sum(), min=1)
    return per_row.mean()


@dataclasses.dataclass
class TrainState:
    """What a training run carries: the model (its parameters) and the
    optimizer (moments, step count, schedule)."""

    model: nn.Module
    optimizer: ScheduledOptimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def make_train_step(loss_fn: Callable[..., torch.Tensor],
                    optimizer: ScheduledOptimizer):
    """Build ``step(*batch) -> loss``: zero the gradients, run
    ``loss_fn(*batch)`` (a scalar) forward and backward, then
    ``optimizer.step()`` (clip by global norm, set the schedule's learning
    rate for this step, update). The returned loss is detached and stays on
    its device: reading it (``float(loss)``) is what waits for the step."""

    def step(*batch):
        optimizer.zero_grad()
        loss = loss_fn(*batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _micro_seed(seed: int, m: int) -> int:
    """The dropout seed of microbatch ``m`` of a step seeded ``seed``."""
    return (seed * 1_000_003 + m + 1) % (1 << 63)


def make_train_step_acc(loss_fn: Callable[..., torch.Tensor],
                        optimizer: ScheduledOptimizer):
    """Gradient-accumulation variant of :func:`make_train_step` (the JAX
    package's ``make_train_step_acc``): ``step(generator, *batch) -> mean
    loss`` where every batch argument carries a leading accumulation axis
    ``A`` (a stacked tensor, or a sequence of ``A`` items) and
    ``loss_fn(generator, *microbatch)`` is a loss whose first argument is
    the dropout generator (None: no dropout stream). The A forwards and
    backwards sum their gradients; the sum is divided by A, then one clip
    and one optimizer update follow, as the JAX package's ``g_sum /
    n_acc``. Microbatch ``m`` draws its dropout masks from a generator on
    the step generator's device seeded from the step generator's seed
    (``initial_seed``) and ``m``, as the JAX package splits the step's key:
    ranks whose step generators are seeded alike draw alike. The returned
    loss is detached and stays on its device."""
    micro_gen = {}

    def step(generator, *batch):
        n_acc = len(batch[0])
        optimizer.zero_grad()
        total = None
        for m in range(n_acc):
            gen = None
            if generator is not None:
                gen = micro_gen.get(generator.device)
                if gen is None:
                    gen = micro_gen[generator.device] = torch.Generator(
                        device=generator.device)
                gen.manual_seed(_micro_seed(generator.initial_seed(), m))
            loss = loss_fn(gen, *(a[m] for a in batch))
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        grads = [p.grad for p in optimizer.params if p.grad is not None]
        torch._foreach_div_(grads, float(n_acc))
        optimizer.step()
        return total / n_acc

    return step


def make_eval_step(model: nn.Module):
    """The evaluation forward of ``model``: ``forward(*args, **kw)`` runs
    it in eval mode (no dropout) under ``torch.inference_mode()`` (no
    autograd record). The JAX package jits a pure deterministic forward
    here; a torch module carries its parameters and its mode, so this
    takes the module. A train step's loss puts the model back in train
    mode."""

    def forward(*args, **kw):
        model.eval()
        with torch.inference_mode():
            return model(*args, **kw)

    return forward
