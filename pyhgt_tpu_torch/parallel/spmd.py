"""Data-parallel and edge-partitioned train steps.

Counterpart of :mod:`pyhgt_tpu.parallel.spmd`. The JAX package
``shard_map``s the unbatched loss over the ``data`` axis, ``pmean``s the
loss and lets the transpose sum the replicated parameters' gradients. Here
each data rank is a process that runs the unbatched loss on its own item;
the gradients (and the loss, in the same buffer) are averaged over the
data group in one all-reduce before the clip and the optimizer, so every
rank takes the same update from the same mean gradient.

Edge partitioning needs nothing more of the step: the partitioned conv
(:mod:`pyhgt_tpu_torch.parallel.edge_partition`) leaves the loss and every
gradient identical on all ranks of a graph group, and dp x gp averages over
the data group of the mesh.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from pyhgt_tpu_torch.parallel import mesh as pmesh
from pyhgt_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from pyhgt_tpu_torch.train.optim import ScheduledOptimizer


def reduce_grads(params: Sequence[torch.Tensor], group, scale: float = 1.0,
                 extra=()) -> list:
    """Sum the gradients of ``params`` (and the scalars ``extra``) over
    ``group`` in one flat f32 all-reduce, times ``scale``; the gradients
    are replaced in place (a missing one counts as zeros and is written).
    Returns the reduced ``extra``."""
    params = list(params)
    if group is None and scale == 1.0:
        return list(extra)
    ref = params[0] if params else extra[0]
    parts = [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1).float() for p in params]
    parts += [torch.as_tensor(e, dtype=torch.float32,
                              device=ref.device).reshape(1) for e in extra]
    flat = pmesh.all_reduce(torch.cat(parts), group, "sum")
    if scale != 1.0:
        flat.mul_(scale)
    at = 0
    for p in params:
        n = p.numel()
        p.grad = flat[at:at + n].view_as(p).to(p.dtype)
        at += n
    return [flat[at + i] for i in range(len(extra))]


def dp_value_and_grad(loss_fn: Callable[..., torch.Tensor],
                      params: Sequence[torch.Tensor], mesh: Mesh):
    """``fn(*batch) -> loss``: this rank's loss forward and backward, then
    the loss and the gradients of ``params`` averaged over the mesh's data
    group (the mean loss is returned, detached, on every rank)."""
    group, n = mesh.group(DATA_AXIS), mesh.size(DATA_AXIS)
    params = list(params)

    def fn(*batch):
        loss = loss_fn(*batch)
        loss.backward()
        (mean,) = reduce_grads(params, group, 1.0 / n,
                               extra=(loss.detach(),))
        return mean

    return fn


def make_step(value_and_grad: Callable[..., torch.Tensor],
              optimizer: ScheduledOptimizer):
    """``step(*args) -> loss``: zero the gradients, ``value_and_grad(*args)``
    (the forward and the backward, and the mode's reductions), then the
    optimizer's clip and update."""

    def step(*args):
        optimizer.zero_grad()
        loss = value_and_grad(*args)
        optimizer.step()
        return loss

    return step


def make_dp_train_step(loss_fn: Callable[..., torch.Tensor],
                       optimizer: ScheduledOptimizer, mesh: Mesh):
    """``step(*batch) -> loss``: :func:`dp_value_and_grad` over the
    optimizer's parameters, then the optimizer's clip and update, the same
    on every data rank."""
    return make_step(dp_value_and_grad(loss_fn, optimizer.params, mesh),
                     optimizer)


def make_gp_train_step(loss_fn: Callable[..., torch.Tensor],
                       optimizer: ScheduledOptimizer, mesh: Mesh):
    """The edge-partitioned step: ``loss_fn`` takes this rank's
    :class:`~pyhgt_tpu_torch.parallel.edge_partition.EdgeShard`, and the
    loss and gradients come out identical on every rank of the graph group
    (no reduction needed for it); under dp x gp the data group averages
    them. It is :func:`make_dp_train_step` on the mesh."""
    return make_dp_train_step(loss_fn, optimizer, mesh)
