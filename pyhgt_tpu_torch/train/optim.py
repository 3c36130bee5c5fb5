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
:class:`ScheduledOptimizer`. :func:`fused_adamw` is the JAX package's
flattened-vector AdamW (the same math over one f32 vector of every
parameter), and :func:`bf16_param_cast` / :func:`with_bf16_params` its
bf16 weight banks at apply time (``param_bf16``).
"""

from __future__ import annotations

import collections
import math
import warnings
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

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


def grad_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of the gradients of ``params``."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float,
                         norm=None):
    """Scale the gradients in place by ``max_norm / max(norm, max_norm)``
    (optax ``clip_by_global_norm``: untouched below the limit, exactly
    ``max_norm`` above it). ``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead, which differs in the sixth digit. No
    device-to-host read. ``norm`` (default: :func:`grad_norm` of
    ``params``) is the global norm to clip by, for parameters spread over
    several processes. Returns the norm before clipping."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if norm is None:
        norm = grad_norm(params)
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer with the JAX package's chain around it:
    clip by global norm, then update at ``schedule(count)``. ``count`` is
    the number of updates made so far, so, as optax does, the first update
    uses ``schedule(0)`` (torch's schedulers are stepped after the
    optimizer, which gives the same sequence). ``norm_fn``, when set, gives
    the global gradient norm the clip uses (the pipeline's parameters are
    spread over its stages)."""

    def __init__(self, inner: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 clip_norm: Optional[float]):
        self.inner, self.schedule, self.clip_norm = inner, schedule, clip_norm
        self.count = 0
        self.norm_fn: Optional[Callable[[], torch.Tensor]] = None

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self):
        """Clip, update at ``schedule(count)`` and advance ``count``.
        Returns the global gradient norm the clip read (a device tensor),
        or None: no clip, or ``FlatAdamW``'s clip inside its update."""
        norm = None
        if self.clip_norm is not None and self.norm_fn is not None:
            norm = self.norm_fn()
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        if isinstance(self.inner, FlatAdamW):
            # the clip runs on the flat gradient vector, inside the update
            self.inner.step(clip_norm=self.clip_norm, norm=norm)
        else:
            if self.clip_norm is not None:
                norm = clip_by_global_norm_(self.params, self.clip_norm, norm)
            self.inner.step()
        self.count += 1
        return norm


def bf16_param_cast(named) -> Dict[str, torch.Tensor]:
    """Compute-dtype view of ``named`` (``named_parameters()`` pairs): the
    weight banks, every parameter :func:`decays` admits, as
    ``.to(torch.bfloat16)``; the numerics-sensitive leaves (biases, norms,
    gates, priors: :data:`NO_DECAY_KEYS`) the f32 parameters themselves.
    The cast is differentiable, so the gradients arrive in f32 on the f32
    masters. The JAX package casts the same leaves (its ``_decay_mask``)."""
    return {n: p.to(torch.bfloat16) if decays(n) else p for n, p in named}


class _Scope(nn.Module):
    """``fn`` as the forward of a module holding ``model``, so that
    ``torch.func.functional_call`` swaps ``model``'s parameters for the
    length of a call of ``fn`` (a loss closure that calls the model)."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def with_bf16_params(fn: Callable, model: nn.Module, named=None) -> Callable:
    """``fn`` (a loss that calls ``model``) run with ``model``'s weight
    banks replaced by their bf16 casts (:func:`bf16_param_cast` of
    ``named``, default every parameter of ``model``, names relative to
    ``model``): the ``param_bf16`` knob, which the JAX package applies to
    the training loss alone. The f32 parameters stay the optimizer's
    masters and receive the gradients in f32. Where a bf16 bank meets f32
    activations the product runs in f32 on the bank's rounded values, the
    dtype ``torch.promote_types`` gives, as JAX promotes."""
    named = list(model.named_parameters() if named is None else named)
    scope = _Scope(model, fn)

    def run(*args, **kwargs):
        cast = {f"model.{n}": t for n, t in bf16_param_cast(named).items()
                if t.dtype == torch.bfloat16}
        return torch.func.functional_call(scope, cast, args, kwargs)

    return run


class FlatAdamW(torch.optim.Optimizer):
    """AdamW over one flattened f32 vector of every parameter: the JAX
    package's ``fused_adamw``, the same math as the per-tensor chain (clip
    by global norm, bias-corrected moments, eps 1e-6 outside the root,
    decoupled decay by a 0/1 mask) in a handful of wide tensor ops. Each
    step concatenates the gradients and the parameters once, updates the
    flat moments, and adds the update back with one multi-tensor add.

    The parameter groups are :func:`make_optimizer`'s two (decay, no
    decay), so a state dict has ``torch.optim.AdamW``'s form and layout and
    loads into either. ``state[p]`` shows each parameter's moments as views
    into the flat buffers (``exp_avg``, ``exp_avg_sq``) and the one step
    count they share (``step``, on the host); loading copies into them
    (:meth:`load_state_dict`,
    :func:`~pyhgt_tpu_torch.train.checkpoint.load_named_optimizer_state`).
    A parameter without a gradient takes a zero one, as in the JAX
    package's dense tree. Raises ``TypeError`` on a parameter that is not
    f32."""

    def __init__(self, groups, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-6):
        params = [p for g in groups for p in g["params"]]
        bad = sorted({str(p.dtype) for p in params
                      if p.dtype != torch.float32})
        if bad:
            raise TypeError(
                f"fused_adamw needs an all-f32 parameter set, got {bad}")
        super().__init__(groups, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=0.0))
        dev = params[0].device
        self._sizes = [p.numel() for p in params]
        n = sum(self._sizes)
        self._mu = torch.zeros(n, device=dev)
        self._nu = torch.zeros(n, device=dev)
        # weight decay times the 0/1 decay mask, per element
        self._decay = torch.cat([
            torch.full((p.numel(),), float(g["weight_decay"]), device=dev)
            for g in self.param_groups for p in g["params"]])
        self._step = torch.zeros((), dtype=torch.float32)
        at = 0
        for p in params:
            k = p.numel()
            self.state[p] = {"step": self._step,
                             "exp_avg": self._mu[at:at + k].view_as(p),
                             "exp_avg_sq": self._nu[at:at + k].view_as(p)}
            at += k

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None, *, clip_norm: Optional[float] = None,
             norm: Optional[torch.Tensor] = None):
        """One update at the groups' ``lr``; ``clip_norm`` clips the flat
        gradient by its global norm (``norm`` when given: a norm read
        across ranks)."""
        if closure is not None:
            raise ValueError("FlatAdamW takes no closure")
        params = self._params()
        g = torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).reshape(-1)
                       for p in params])
        flat = torch.cat([p.reshape(-1) for p in params])
        if clip_norm is not None:
            gnorm = torch.linalg.vector_norm(g) if norm is None else norm
            g = g * torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-16),
                                max=1.0)
        group = self.param_groups[0]
        (b1, b2), eps, lr = group["betas"], group["eps"], group["lr"]
        self._step += 1
        c = float(self._step)
        self._mu.mul_(b1).add_(g, alpha=1.0 - b1)
        self._nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (self._nu / (1.0 - b2 ** c)).sqrt_().add_(eps)
        upd = (self._mu / (1.0 - b1 ** c)).div_(denom)
        upd.addcmul_(self._decay, flat).mul_(-lr)
        torch._foreach_add_(params, [u.view_as(p) for u, p in
                                     zip(upd.split(self._sizes), params)])

    def state_dict(self):
        """``torch.optim.AdamW``'s form: each parameter's moments and step
        as tensors of their own."""
        sd = super().state_dict()
        sd["state"] = {i: {k: v.clone() for k, v in st.items()}
                       for i, st in sd["state"].items()}
        return sd

    def load_state_dict(self, state_dict):
        """Load an AdamW or FlatAdamW state dict by copying each
        parameter's moments into the flat buffers (a parameter the dict
        holds no state for restarts from zero moments)."""
        views = dict(self.state)
        super().load_state_dict(state_dict)
        loaded = self.state
        for p, st in views.items():
            new = loaded.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in new:
                    st[k].copy_(new[k])
                else:
                    st[k].zero_()
            if "step" in new:
                self._step.copy_(new["step"])
        self.state = collections.defaultdict(dict, views)


def _decay_groups(named, weight_decay: float):
    """The two AdamW parameter groups: decoupled decay on the parameters
    :func:`decays` admits, none on biases, norms and gates."""
    return [
        {"params": [p for n, p in named if decays(n)],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named if not decays(n)],
         "weight_decay": 0.0},
    ]


def _as_schedule(schedule) -> Callable[[int], float]:
    if callable(schedule):
        return schedule
    constant = float(schedule)
    return lambda step: constant


def fused_adamw(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                schedule, weight_decay: float = 0.01,
                clip_norm: Optional[float] = 0.25, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-6) -> ScheduledOptimizer:
    """The flattened-vector AdamW of the JAX package (``fused_adamw``)
    over ``named_params``: :class:`FlatAdamW` under the schedule, the clip
    on the flat gradient. Raises ``TypeError`` unless every parameter is
    f32 (:func:`make_optimizer` then falls back to the per-tensor AdamW,
    as the JAX package does)."""
    named = list(named_params)
    schedule = _as_schedule(schedule)
    inner = FlatAdamW(_decay_groups(named, weight_decay), lr=schedule(0),
                      betas=(b1, b2), eps=eps)
    return ScheduledOptimizer(inner, schedule, clip_norm)


def make_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                   schedule, weight_decay: float = 0.01,
                   clip_norm: Optional[float] = 0.25, name: str = "adamw",
                   fused: bool = False) -> ScheduledOptimizer:
    """Optimizer factory + global-norm clip over ``named_params`` (a
    model's ``named_parameters()``). ``schedule`` is a function of the step
    or a constant.

    ``name`` mirrors the reference's ``--optimizer`` choices
    (``OAG/train_paper_field.py:42-44,198-205``): ``adamw`` (eps 1e-6;
    decoupled decay on the parameters :func:`decays` admits, none on biases,
    norms and gates: two parameter groups compute what ``optax.adamw`` with
    its mask does), ``adam``, ``sgd``, ``adagrad`` (accumulator from 0.1 as
    optax's; torch adds its eps outside the root, optax inside). ``fused``
    (``adamw`` only) selects :func:`fused_adamw`, the same math over one
    flat vector; a parameter set it refuses (not all f32) falls back to
    the per-tensor AdamW with a warning, as the JAX package falls back."""
    named = list(named_params)
    if name == "adamw" and fused:
        try:
            return fused_adamw(named, schedule, weight_decay=weight_decay,
                               clip_norm=clip_norm)
        except TypeError as e:
            warnings.warn(f"{e}: fused_opt falls back to the per-tensor "
                          "AdamW", RuntimeWarning, stacklevel=2)
    schedule = _as_schedule(schedule)
    lr0 = schedule(0)
    params = [p for _, p in named]
    if name == "adamw":
        inner = torch.optim.AdamW(_decay_groups(named, weight_decay), lr=lr0,
                                  betas=(0.9, 0.999), eps=1e-6)
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
