"""Optimizers and LR schedules.

Counterpart of :mod:`pyhgt_tpu.train.optim`. Parity targets:

- AdamW with no-weight-decay groups for biases / norms
  (``ogbn-mag/train_ogbn_mag.py:119-127``)
- CosineAnnealingLR(1000, eta_min=1e-6) (``OAG/train_paper_field.py:205-207``)
- OneCycleLR(max_lr=5e-4, pct_start=0.05, anneal_strategy='linear')
  (``ogbn-mag/train_ogbn_mag.py:128-129``)
- global-norm gradient clipping (``OAG/train_paper_field.py:251``: 0.25;
  ``ogbn-mag/train_ogbn_mag.py:57``: 1.0)

The schedules are plain functions of the step (Python floats). The update
rules are the library's (``torch.optim``); the two places where the JAX
package's optax chain differs from torch's own helpers are written out in
:class:`ScheduledOptimizer`. The flattened-vector ``fused_adamw`` and
``bf16_param_cast`` are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple

import torch

# Parameter-name components excluded from weight decay, mirroring the
# reference's ['bias', 'LayerNorm.weight'] no-decay group plus the scalar
# banks (skip gate, relation priors behave like norms/gates).
NO_DECAY_KEYS = (
    "bias", "bq", "bk", "bv", "ba", "adapt_b", "rte_b",
    "ln_scale", "ln_bias", "scale",
    "skip", "rel_pri",
)


def decays(name: str) -> bool:
    """Whether the parameter called ``name`` (a ``named_parameters`` key
    such as ``gnn.convs.0.bq``) takes weight decay: no component of its
    dotted name is in :data:`NO_DECAY_KEYS`. The JAX package applies the
    same rule to the flax path of the same leaf."""
    return not any(part in NO_DECAY_KEYS for part in name.split("."))


def cosine_schedule(lr: float = 1e-3, period: int = 1000,
                    eta_min: float = 1e-6) -> Callable[[int], float]:
    """Cosine decay from ``lr`` to ``eta_min`` over ``period`` steps,
    clamped at the period end (optax ``cosine_decay_schedule`` with
    ``alpha = eta_min / lr``)."""
    alpha = eta_min / lr

    def schedule(step):
        t = min(step, period) / period
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t))
                     + alpha)

    return schedule


def cosine_torch_schedule(lr: float = 1e-3, period: int = 1000,
                          eta_min: float = 1e-6, start_step: int = 1500
                          ) -> Callable[[int], float]:
    """torch ``CosineAnnealingLR`` closed form as the reference drives it:
    ``scheduler.step(train_step)`` with ``train_step`` starting at 1500
    (``OAG/train_paper_field.py:205-212``, ``:256``). The curve oscillates
    past the period end (no clamp) and begins mid-cycle."""

    def schedule(step):
        t = step + float(start_step)
        return eta_min + (lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t / float(period)))

    return schedule


def onecycle_schedule(max_lr: float = 5e-4, total_steps: int = 1000,
                      pct_start: float = 0.05, div_factor: float = 25.0,
                      final_div_factor: float = 10.0, anneal: str = "linear"
                      ) -> Callable[[int], float]:
    """torch OneCycleLR(three_phase=False) semantics with the reference's
    knobs (``ogbn-mag/train_ogbn_mag.py:128-129``): rise from
    ``max_lr/div_factor`` to ``max_lr`` over ``pct_start*total_steps - 1``
    steps (a fractional boundary), then anneal to
    ``max_lr/(div_factor*final_div_factor)`` over the rest. Phase lengths
    are floored at a tiny positive value so a tiny ``total_steps`` never
    divides by zero."""
    total_steps = max(int(total_steps), 2)
    up = max(float(pct_start * total_steps) - 1.0, 1e-9)
    down = max(float(total_steps) - up - 1.0, 1e-9)
    init = max_lr / div_factor
    final = init / final_div_factor

    def interp(start, end, pct):
        if anneal == "cos":
            return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))
        return start + (end - start) * pct

    def schedule(step):
        s = float(step)
        if s <= up:
            return interp(init, max_lr, min(max(s / up, 0.0), 1.0))
        return interp(max_lr, final, min(max((s - up) / down, 0.0), 1.0))

    return schedule


def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float):
    """Scale the gradients in place by ``max_norm / max(norm, max_norm)``
    (optax ``clip_by_global_norm``: untouched below the limit, exactly
    ``max_norm`` above it). ``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead, which differs in the sixth digit. No
    device-to-host read. Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer with the JAX package's chain around it:
    clip by global norm, then update at ``schedule(count)``. ``count`` is
    the number of updates made so far, so, as optax does, the first update
    uses ``schedule(0)`` (torch's schedulers are stepped after the
    optimizer, which gives the same sequence)."""

    def __init__(self, inner: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 clip_norm: Optional[float]):
        self.inner, self.schedule, self.clip_norm = inner, schedule, clip_norm
        self.count = 0

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self):
        if self.clip_norm is not None:
            clip_by_global_norm_(self.params, self.clip_norm)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1


def make_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                   schedule, weight_decay: float = 0.01,
                   clip_norm: Optional[float] = 0.25, name: str = "adamw"
                   ) -> ScheduledOptimizer:
    """Optimizer factory + global-norm clip over ``named_params`` (a
    model's ``named_parameters()``). ``schedule`` is a function of the step
    or a constant.

    ``name`` mirrors the reference's ``--optimizer`` choices
    (``OAG/train_paper_field.py:42-44,198-205``): ``adamw`` (eps 1e-6;
    decoupled decay on the parameters :func:`decays` admits, none on biases,
    norms and gates: two parameter groups compute what ``optax.adamw`` with
    its mask does), ``adam``, ``sgd``, ``adagrad`` (accumulator from 0.1 as
    optax's; torch adds its eps outside the root, optax inside)."""
    named = list(named_params)
    if not callable(schedule):
        constant = float(schedule)
        schedule = lambda step: constant  # noqa: E731
    lr0 = schedule(0)
    params = [p for _, p in named]
    if name == "adamw":
        groups = [
            {"params": [p for n, p in named if decays(n)],
             "weight_decay": weight_decay},
            {"params": [p for n, p in named if not decays(n)],
             "weight_decay": 0.0},
        ]
        inner = torch.optim.AdamW(groups, lr=lr0, betas=(0.9, 0.999),
                                  eps=1e-6)
    elif name == "adam":
        inner = torch.optim.Adam(params, lr=lr0)
    elif name == "sgd":
        inner = torch.optim.SGD(params, lr=lr0)
    elif name == "adagrad":
        inner = torch.optim.Adagrad(params, lr=lr0,
                                    initial_accumulator_value=0.1, eps=1e-7)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return ScheduledOptimizer(inner, schedule, clip_norm)
