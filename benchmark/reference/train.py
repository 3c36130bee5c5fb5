"""The plain reference's training steps: the loss of
:mod:`benchmark.reference.hgt`, its gradients by autograd, the clip by
global norm and AdamW, as the configuration states them (pyHGT
``train_ogbn_mag.py:119-160``, ``train_paper_field.py:198-256``):

- clip: every gradient scaled by ``clip / max(norm, clip)``;
- AdamW (betas 0.9 / 0.999, eps 1e-6 outside the root, bias-corrected),
  decoupled weight decay on every parameter but biases, norms, gates and
  priors (a name part in :data:`NO_DECAY`);
- the learning rate of update ``k`` (from 0) is the schedule at ``k``:
  OneCycle with a linear anneal, or a cosine decay to 1e-6 over 1,000
  steps.

:func:`run_steps` follows the program's first steps from the same weights
on the same batches and dropout streams and returns what the comparison
reads: each step's loss, each parameter's first gradient (as the
optimizer got it, clipped) and its change after the last step, as norms,
and the first step's input to the first layer. The network is the
configuration's ``reference`` module.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch

from benchmark import reference

NO_DECAY = ("bias", "bq", "bk", "bv", "ba", "adapt_b", "rte_b", "ln_scale",
            "ln_bias", "scale", "skip", "rel_pri")


def decays(name: str) -> bool:
    return not any(part in NO_DECAY for part in name.split("."))


def schedule(cfg: dict) -> Callable[[int], float]:
    if cfg["scheduler"] == "onecycle":
        total = max(int(cfg["n_epoch"] * cfg["n_batch"] * cfg["repeat"]), 1) + 1
        up = max(cfg["onecycle_pct_start"] * total - 1.0, 1e-9)
        down = max(total - up - 1.0, 1e-9)
        init = cfg["max_lr"] / 25.0
        final = init / cfg["onecycle_final_div"]

        def lr(k):
            if k <= up:
                return init + (cfg["max_lr"] - init) * min(k / up, 1.0)
            return cfg["max_lr"] + (final - cfg["max_lr"]) * min(
                (k - up) / down, 1.0)
        return lr
    if cfg["scheduler"] == "cosine":
        alpha = 1e-6 / cfg["max_lr"]

        def lr(k):
            t = min(k, 1000) / 1000
            return cfg["max_lr"] * ((1 - alpha) * 0.5
                                    * (1 + math.cos(math.pi * t)) + alpha)
        return lr
    raise ValueError(f"no reference schedule {cfg['scheduler']!r}")


def run_steps(params0: Dict[str, torch.Tensor], batches: Sequence,
              step_seeds: Sequence[int], cfg: dict, metas, device,
              control: str = "", half_batch: bool = False) -> dict:
    """``len(batches)`` reference steps from ``params0`` (left unchanged).
    ``control``: a lower precision (the reference's ``Precision``); ``half_batch``
    is a planted fault: the second half of every batch's
    live label rows left out, the mean taken over the rest."""
    net = reference.for_config(cfg)
    prec = net.Precision(cfg["edge_bf16"], control)
    names = sorted(params0)
    params = {n: params0[n].detach().clone().requires_grad_(True)
              for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    lr_of = schedule(cfg)
    b1, b2, eps = 0.9, 0.999, 1e-6
    losses, grad_norms, taps = [], None, {}
    for k, (batch, seed) in enumerate(zip(batches, step_seeds)):
        if half_batch:
            live = batch.label_mask.nonzero()[0]
            mask = batch.label_mask.copy()
            mask[live[len(live) // 2:]] = False
            batch = type(batch)(**{**batch.__dict__, "label_mask": mask})
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        masks = net.dropout_masks(gen, len(batch.types), batch.node_cap,
                                  cfg["n_hid"], cfg["n_layers"],
                                  cfg["dropout"], device)
        logp = net.forward(params, batch, cfg, metas, prec, masks, device,
                           taps if k == 0 else None)
        loss = net.loss(logp, batch, cfg, device)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = cfg["clip"] / max(float(norm), cfg["clip"])
        grads = [g * scale for g in grads]
        if k == 0:
            grad_norms = {n: float(g.double().norm())
                          for n, g in zip(names, grads)}
        lr = lr_of(k)
        t = k + 1
        with torch.no_grad():
            for n, g in zip(names, grads):
                p = params[n]
                if decays(n):
                    p.mul_(1 - lr * cfg["weight_decay"])
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
        losses.append(float(loss.detach()))
    change = {n: float((params[n].detach() - params0[n]).double().norm())
              for n in names}
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change,
                inputs=[x.detach().cpu() for x in taps["input"]])
