"""GPipe pipeline parallelism for the conv stack.

Counterpart of :mod:`pyhgt_tpu.parallel.pipeline`. The ``n_layers``
homogeneous convs of a task model's GNN split into ``S`` contiguous stages
of ``L / S`` layers over the ranks of a ``pipe`` axis; microbatches (each
an independent subgraph, the dp unit) stream through them on the GPipe
schedule:

- stage 0 embeds each microbatch (the input adapters), the last stage runs
  the task head and its loss; the loss is the sum over the pipe group
  divided by the microbatch count M (the mean over microbatches), and under
  dp x pp also the mean over the data ranks;
- stage ``s`` runs microbatch ``m`` once it has received its activation
  ``[T, C, D]`` from stage ``s - 1`` (so at step ``t`` it works on
  microbatch ``t - s``) and sends its own to stage ``s + 1``
  (:func:`~pyhgt_tpu_torch.parallel.mesh.send` / ``recv``, the JAX
  package's ``ppermute``);
- after the M forwards, the backward runs the microbatches in reverse:
  each stage receives its output's gradient from stage ``s + 1``, calls
  ``torch.autograd.backward`` on its output and sends its input's gradient
  back to ``s - 1`` (the transpose of the ``ppermute``, which JAX derives).

The ``shared`` parameters (the adapters and the task head) sit on every
stage and get gradient only where they are used (stage 0, the last stage);
their gradients are summed over the pipe group, as JAX's transpose of the
replicated parameters does, so every copy takes the same update. The
global-norm clip reads the norm across the stages.

Every rank holds the whole model; a stage trains its own layers and the
shared parameters. :func:`gather_pipeline_params` collects the stages on
the first rank, in the JAX package's stacked form
(:func:`stack_pipeline_params`), for checkpoints and the single-device
evaluation (:func:`unstack_pipeline_params`).

Constraints kept from the JAX package: ``n_layers % S == 0``,
``prev_norm == last_norm`` (the stages must be homogeneous there), and pp
composes with dp only. The bubble is ``(S - 1) / (M + S - 1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from pyhgt_tpu_torch.parallel import mesh as pmesh
from pyhgt_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS, Mesh
from pyhgt_tpu_torch.parallel.spmd import make_step, reduce_grads
from pyhgt_tpu_torch.train.optim import ScheduledOptimizer

CONVS = "gnn.convs."


def make_pipe_mesh(n_pipe: int, n_data: int = 1) -> Mesh:
    """The ``(data, pipe)`` mesh over the world: each data rank's row runs
    its own pipeline over its own microbatches."""
    return Mesh({DATA_AXIS: n_data, PIPE_AXIS: n_pipe})


def stack_pipeline_params(named: Mapping[str, torch.Tensor], n_layers: int,
                          n_stages: int) -> Dict[str, Dict]:
    """A task model's named tensors (``state_dict()`` or
    ``named_parameters()``) -> ``{"stages": {leaf: [S, L/S, ...]},
    "shared": {name: tensor}}``: ``stages`` stacks each conv leaf (keyed by
    its name within a conv, as ``wq`` or ``mid.weight``) over the layers,
    ``shared`` is every tensor outside the convs (the adapters, the head).
    The JAX package's tree of the same name, under the port's names."""
    if n_layers % n_stages:
        raise ValueError(f"n_layers={n_layers} not divisible by "
                         f"n_stages={n_stages}")
    named = dict(named)
    leaves = [k[len(f"{CONVS}0."):] for k in named
              if k.startswith(f"{CONVS}0.")]
    stages = {
        leaf: torch.stack([named[f"{CONVS}{i}.{leaf}"]
                           for i in range(n_layers)]).reshape(
            (n_stages, n_layers // n_stages)
            + tuple(named[f"{CONVS}0.{leaf}"].shape))
        for leaf in leaves}
    shared = {k: v for k, v in named.items() if not k.startswith(CONVS)}
    return {"stages": stages, "shared": shared}


def unstack_pipeline_params(pp_params: Mapping, n_layers: int
                            ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_pipeline_params`: the model's named tensors
    (a ``state_dict`` to load for a checkpoint or a single-device
    evaluation)."""
    out = dict(pp_params["shared"])
    for leaf, a in pp_params["stages"].items():
        flat = a.reshape((n_layers,) + tuple(a.shape[2:]))
        for i in range(n_layers):
            out[f"{CONVS}{i}.{leaf}"] = flat[i]
    return out


def check_pipeline(n_layers: int, pp: int, prev_norm: bool, last_norm: bool,
                   dp: int = 1, tp: int = 1, gp: int = 1) -> None:
    """The JAX package's pp preconditions."""
    if tp > 1 or gp > 1:
        raise ValueError("pp composes with dp only (pp x tp / pp x gp are "
                         "not wired)")
    if prev_norm != last_norm:
        raise ValueError("pp needs a homogeneous conv stack: set "
                         "prev_norm == last_norm")
    if n_layers % pp:
        raise ValueError(f"n_layers={n_layers} % pp={pp} != 0")


@dataclasses.dataclass
class Stage:
    """This rank's stage of the pipeline over ``model`` (a task model with
    a ``gnn``): its layers and the parameters it trains."""

    model: torch.nn.Module
    mesh: Mesh

    def __post_init__(self):
        S, s = self.mesh.size(PIPE_AXIS), self.mesh.index(PIPE_AXIS)
        L = len(self.model.gnn.convs)
        if L % S:
            raise ValueError(f"n_layers={L} % pp={S} != 0")
        self.per = L // S
        self.S, self.s = S, s
        self.layers = list(range(s * self.per, (s + 1) * self.per))

    def named_parameters(self):
        """The parameters this stage trains: its layers' and the shared
        ones (everything outside the convs)."""
        own = tuple(f"{CONVS}{i}." for i in self.layers)
        return [(n, p) for n, p in self.model.named_parameters()
                if not n.startswith(CONVS) or n.startswith(own)]

    def shared_parameters(self):
        return [p for n, p in self.model.named_parameters()
                if not n.startswith(CONVS)]

    def stage_parameters(self):
        own = tuple(f"{CONVS}{i}." for i in self.layers)
        return [p for n, p in self.model.named_parameters()
                if n.startswith(own)]

    def peer(self, offset: int) -> int:
        return self.mesh.members(PIPE_AXIS)[self.s + offset]


def make_pp_task_loss(model: torch.nn.Module, head_loss: Callable,
                      mesh: Mesh, n_micro: int, em):
    """The pipelined loss of a task model, forward and backward:
    ``fn(generator, micro) -> loss`` where ``micro`` holds the M
    microbatches, each ``(node_feat, node_mask, se, edges, *labels)`` on
    this rank's device (every stage gets every microbatch, as in the JAX
    package), and ``head_loss(model, h_out, *labels)`` is the task's loss
    of one microbatch from the last stage's activation. Runs the GPipe
    schedule, leaves each trained parameter's gradient (the shared ones
    summed over the pipe group; all of them averaged over the data group)
    and returns the loss, the same on every rank. The JAX function returns
    a loss that ``value_and_grad`` differentiates; here the stages trade
    gradients by hand, so the backward is part of the call."""
    stage = Stage(model, mesh)
    S, s, M = stage.S, stage.s, n_micro
    gnn = model.gnn
    layers = [gnn.convs[i] for i in stage.layers]
    pipe = mesh.group(PIPE_AXIS)
    data, n_data = mesh.group(DATA_AXIS), mesh.size(DATA_AXIS)
    shared, own = stage.shared_parameters(), stage.stage_parameters()
    D = gnn.adapt_w.shape[-1]

    def fn(generator, micro: Sequence):
        if len(micro) != M:
            raise ValueError(f"{len(micro)} microbatches, the pipeline "
                             f"takes {M}")
        model.train()
        saved = []
        total = None
        for m in range(M):                                   # forward
            nf, nmk, se, edges, *labels = micro[m]
            if s == 0:
                h_in = None
                h = gnn.embed(nf, nmk, generator)
            else:
                h_in = pmesh.recv((nf.shape[0], nf.shape[1], D),
                                  torch.float32, nf.device, stage.peer(-1),
                                  pipe)
                h = h_in.requires_grad_()
            for conv in layers:
                h = conv(h, nmk, se, em, generator, edges)
            if s == S - 1:
                out = head_loss(model, h, *labels) / M
                total = out.detach() if total is None \
                    else total + out.detach()
            else:
                pmesh.send(h.detach(), stage.peer(1), pipe)
                out = h
            saved.append((h_in, out))
        for m in reversed(range(M)):                         # backward
            h_in, out = saved[m]
            if s == S - 1:
                torch.autograd.backward(out)
            else:
                g = pmesh.recv(out.shape, out.dtype, out.device,
                               stage.peer(1), pipe)
                torch.autograd.backward(out, g)
            if s > 0:
                pmesh.send(h_in.grad, stage.peer(-1), pipe)
        saved.clear()
        if total is None:
            total = torch.zeros((), device=gnn.adapt_w.device)
        (loss,) = reduce_grads(shared, pipe, extra=(total,))
        if n_data > 1:
            (loss,) = reduce_grads(own + shared, data, 1.0 / n_data,
                                   extra=(loss,))
        return loss

    fn.stage = stage
    return fn


def make_pp_norm(stage: Stage, mesh: Mesh) -> Callable[[], torch.Tensor]:
    """The global gradient norm of the whole pipelined model, for the
    clip: every stage's layers once (summed over the pipe group) and the
    shared parameters once."""
    pipe = mesh.group(PIPE_AXIS)

    def sq(params):
        grads = [p.grad for p in params if p.grad is not None]
        return torch.stack(torch._foreach_norm(grads)).square().sum()

    def norm():
        own = pmesh.all_reduce(sq(stage.stage_parameters()).reshape(1),
                               pipe, "sum")[0]
        return torch.sqrt(own + sq(stage.shared_parameters()))

    return norm


def make_pp_loss(fl, mesh: Mesh, n_micro: int):
    """The flagship's pipelined loss (:func:`make_pp_task_loss` with the
    classifier and the NLL of the paper seeds): ``fn(generator, micro)``
    with ``micro[m] = (node_feat, node_mask, se, None, labels)``."""
    from pyhgt_tpu_torch.train.step import nll_loss

    c = fl.cfg
    if c.n_layers % mesh.size(PIPE_AXIS):
        raise ValueError(f"n_layers={c.n_layers} % pp != 0")

    def head_loss(model, h, labels):
        return nll_loss(model.head(h), labels)

    return make_pp_task_loss(fl.model, head_loss, mesh, n_micro, fl.em_dev)


def make_pp_value_and_grad(loss_fn, optimizer: ScheduledOptimizer,
                           mesh: Mesh):
    """Wire the optimizer's clip to the pipeline's global norm and return
    ``loss_fn`` (it runs its own backward)."""
    optimizer.norm_fn = make_pp_norm(loss_fn.stage, mesh)
    return loss_fn


def make_pp_train_step(loss_fn, optimizer: ScheduledOptimizer, mesh: Mesh):
    """``step(generator, micro) -> loss``: the pipelined loss and its
    backward (:func:`make_pp_task_loss` / :func:`make_pp_loss`), then the
    clip by the pipeline's global norm and the update of this stage's
    parameters (``optimizer`` over :meth:`Stage.named_parameters`)."""
    return make_step(make_pp_value_and_grad(loss_fn, optimizer, mesh),
                     optimizer)


def gather_pipeline_params(model: torch.nn.Module, mesh: Mesh
                           ) -> Optional[Dict[str, Dict]]:
    """Collect the stages' current layers on the first rank of each pipe
    group (every rank of the mesh calls this): that rank's model then holds
    every stage's layers, and it returns the model's parameters in the
    stacked form (:func:`stack_pipeline_params`); the other ranks return
    None."""
    S, s = mesh.size(PIPE_AXIS), mesh.index(PIPE_AXIS)
    pipe, members = mesh.group(PIPE_AXIS), mesh.members(PIPE_AXIS)
    L = len(model.gnn.convs)
    per = L // S
    with torch.no_grad():
        for st in range(1, S):
            for i in range(st * per, (st + 1) * per):
                for _, p in model.gnn.convs[i].named_parameters():
                    if s == st:
                        pmesh.send(p.detach(), members[0], pipe)
                    elif s == 0:
                        p.copy_(pmesh.recv(p.shape, p.dtype, p.device,
                                           members[st], pipe))
    if s != 0:
        return None
    named = {n: p.detach() for n, p in model.named_parameters()}
    return stack_pipeline_params(named, L, S)


@dataclasses.dataclass
class ExportedState:
    """What a pipeline's first rank writes as a checkpoint: the whole model
    (the stages gathered) and the step; no optimizer state (it is spread
    over the stages), so a resume starts the optimizer afresh."""

    model: torch.nn.Module
    step: int
    optimizer: object = None
