"""The one-device train step, captured in CUDA graphs and replayed.

An eager step of the flagship model launches about 1,500 kernels, and the
host's Python dispatch of them, not the card, sets the pace when the
loader's threads share the host. :class:`GraphedStep` records the whole
step (zero-grad, forward, loss, backward, the global-norm clip and the
AdamW update) once in a ``torch.cuda.CUDAGraph`` and then replays it for
every batch of the same signature: one graph launch instead of the
step's launches.

A replay reads its inputs where the capture read them, so the step owns
two :class:`~pyhgt_tpu_torch.train.loader.InputSlots`, into which the
loaders of its device copy their items (ping-pong: the loader's pending
item in one, the next in the other), and one graph per slot; the two
graphs share one memory pool, since they never run at once. Nothing read
on the host is baked into a graph: the AdamW update reads the numbers
that depend on the step (the learning rate of ``schedule(count)``, the
bias corrections) from a device tensor filled before each replay
(:class:`_AdamWUpdate`), and the caller's dropout generator is
registered with the graph, so a replay draws from the seed the caller
has just set, at the offsets an eager step would use.
"""

from __future__ import annotations

import dataclasses
import numbers
import warnings
from typing import Callable, Optional

import torch
from torch import nn

from pyhgt_tpu_torch.train.loader import InputSlots
from pyhgt_tpu_torch.train.optim import (
    ScheduledOptimizer,
    clip_by_global_norm_,
)
from pyhgt_tpu_torch.utils import counters

# at most this many graphs: one per input slot of one signature
MAX_GRAPHS = InputSlots.COUNT


def signature(batch):
    """``(key, tensors)`` of a step's arguments: ``key`` holds each
    tensor leaf's shape, stride, dtype and device and every other field
    (a kernel aux's ``w``, ``window``, ``dead_rows``, ...) through
    dataclasses, tuples, lists and dicts, and ``tensors`` lists the leaves
    in that order. ``key`` is None when a leaf is of a kind a graph cannot
    take as an input (a numpy array: the step would copy it each time)."""
    tensors = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            tensors.append(o)
            return ("T", tuple(o.shape), o.stride(), o.dtype, o.device)
        if o is None or isinstance(o, (numbers.Number, str, torch.dtype)):
            return o
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return (type(o),) + tuple(walk(getattr(o, f.name))
                                      for f in dataclasses.fields(o))
        if isinstance(o, (tuple, list)):
            return (type(o),) + tuple(walk(x) for x in o)
        if isinstance(o, dict):
            return (dict,) + tuple((k, walk(v)) for k, v in o.items())
        raise _Unkeyed

    try:
        return walk(tuple(batch)), tensors
    except _Unkeyed:
        return None, tensors


class _Unkeyed(Exception):
    pass


def hooked(model: nn.Module) -> bool:
    """Whether a forward or backward hook (or pre-hook) is registered on
    ``model``, on one of its modules or globally: a replay would skip
    it."""
    m = nn.modules.module
    if (m._global_forward_hooks or m._global_forward_pre_hooks
            or m._global_backward_hooks or m._global_backward_pre_hooks):
        return True
    return any(mod._forward_hooks or mod._forward_pre_hooks
               or mod._backward_hooks or mod._backward_pre_hooks
               for mod in model.modules())


def _plain_adamw(opt: torch.optim.Optimizer) -> bool:
    """Whether ``opt`` is a ``torch.optim.AdamW`` that :class:`_AdamWUpdate`
    reproduces: float hyperparameters, the step counts on the host, no
    amsgrad, maximize, fused or differentiable form."""
    return type(opt) is torch.optim.AdamW and all(
        not (g["amsgrad"] or g["maximize"] or g["capturable"]
             or g["differentiable"] or g.get("fused"))
        and g.get("decoupled_weight_decay", True)
        and not any(torch.is_tensor(x) for x in (g["lr"], *g["betas"]))
        for g in opt.param_groups)


class _NotCapturable(Exception):
    pass


class _AdamWUpdate:
    """One update of a ``torch.optim.AdamW`` (:func:`_plain_adamw`), of the
    parameters that have a gradient, in a form a graph can record: the
    foreach operations of torch's own AdamW, on its own state, with the
    numbers torch computes on the host in double for each step (the decay
    factor ``1 - lr * weight_decay``, ``sqrt(1 - beta2 ** t)`` and ``-lr /
    (1 - beta1 ** t)``, rounded to f32 as torch's kernels round them) read
    from ``scalars`` (``[groups, 3]`` on the device), which
    :meth:`advance` fills before the update runs; the step counts stay
    AdamW's, on the host, advanced there. Only the last operation is
    ordered otherwise, as torch's capturable AdamW orders it (the
    denominator divided by the step size, then ``exp_avg / denominator``
    added, where torch adds ``step_size * exp_avg / denominator``): a
    parameter then differs from torch's by about an ulp of itself or of
    its update. ``make_state`` creates the state of a parameter that has
    none, as torch's first update does; without it (in a capture, which
    would record the zero fill) such a parameter refuses the update."""

    def __init__(self, adamw: torch.optim.AdamW, scalars: torch.Tensor,
                 make_state: bool = False):
        self.scalars, self.groups, self._tensors = scalars, [], []
        for g, group in enumerate(adamw.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            for p in params:
                if not adamw.state.get(p):
                    if not make_state:
                        raise _NotCapturable("a parameter has no AdamW "
                                             "state yet")
                    adamw.state[p] = dict(
                        step=torch.tensor(0.0),
                        exp_avg=torch.zeros_like(
                            p, memory_format=torch.preserve_format),
                        exp_avg_sq=torch.zeros_like(
                            p, memory_format=torch.preserve_format))
            states = [adamw.state[p] for p in params]
            steps = [st["step"] for st in states]
            if any(t.device.type != "cpu" for t in steps) \
                    or len({float(t) for t in steps}) > 1:
                raise _NotCapturable("AdamW's step counts differ")
            if params:
                self.groups.append((g, group, steps))
                self._tensors.append(dict(
                    params=params, grads=[p.grad for p in params],
                    exp_avgs=[st["exp_avg"] for st in states],
                    exp_avg_sqs=[st["exp_avg_sq"] for st in states]))

    @torch.no_grad()
    def record(self) -> None:
        """Run (or, in a capture, record) the update; it keeps no tensor
        after: a capture's gradients must be free for the next capture,
        which shares the memory pool."""
        tensors, self._tensors = self._tensors, []
        for (g, group, _), t in zip(self.groups, tensors):
            params = t["params"]
            decay, bc2_sqrt, step_size = self.scalars[g].unbind(0)
            beta1, beta2 = group["betas"]
            if group["weight_decay"] != 0:
                torch._foreach_mul_(params, decay)
            torch._foreach_lerp_(t["exp_avgs"], t["grads"], 1 - beta1)
            torch._foreach_mul_(t["exp_avg_sqs"], beta2)
            torch._foreach_addcmul_(t["exp_avg_sqs"], t["grads"],
                                    t["grads"], 1 - beta2)
            denom = torch._foreach_sqrt(t["exp_avg_sqs"])
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(denom, step_size)
            torch._foreach_addcdiv_(params, t["exp_avgs"], denom)

    def advance(self, lr: float) -> None:
        """Count the update and fill ``scalars`` for it at ``lr``, as
        torch's AdamW computes them."""
        rows = self.scalars.new_zeros(self.scalars.shape, device="cpu")
        for g, group, steps in self.groups:
            torch._foreach_add_(steps, torch.tensor(1.0), alpha=1.0)
            t = float(steps[0])
            beta1, beta2 = group["betas"]
            rows[g] = torch.tensor([1 - lr * group["weight_decay"],
                                    (1 - beta2 ** t) ** 0.5,
                                    (lr / (1 - beta1 ** t)) * -1],
                                   dtype=torch.float64)
        if self.scalars.is_cuda:
            rows = rows.pin_memory()
        self.scalars.copy_(rows, non_blocking=True)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    loss: torch.Tensor           # the step's loss, written by each replay
    norm: Optional[torch.Tensor]  # its gradient norm before the clip
    generator: Optional[torch.Generator]
    update: _AdamWUpdate
    counts: dict                 # what it advances of the host counters
    state: tuple                 # what it bakes in of the optimizer


class GraphedStep:
    """``step(generator, *batch) -> loss``, :func:`make_train_step`'s step
    (``loss_fn(generator, *batch)``: zero-grad, forward, loss, backward,
    clip, update; the loss detached, on the device), replayed from CUDA
    graphs where it can be.

    Graphs engage when ``capture`` is true (the caller's configuration
    has nothing that must stay eager), the parameters are on a CUDA
    device and ``optimizer`` wraps a plain ``torch.optim.AdamW`` (the
    per-tensor AdamW of both presets); then, for each call, when no hook
    is registered on ``model`` and the batch's :func:`signature` and input
    addresses are a captured graph's with the same generator. The first
    step of a signature runs eagerly (it makes the optimizer state and the
    library handles); a later one whose inputs lie in one of the step's
    input slots is captured and replayed, at most :data:`MAX_GRAPHS`
    graphs in all (a batch of another signature then runs eagerly).
    Where graphs do not engage (the CPU among them), every step is
    :func:`make_train_step`'s.

    Where they do, every step runs on a stream of its own that waits for
    the caller's stream and that the caller's stream waits for, and an
    eager step updates in the graphs' form (:class:`_AdamWUpdate`).
    Counters: ``captures``, ``replays`` (the steps a graph ran, a
    capture's included) and ``eager_steps``. ``grad_norm`` is the last
    step's global gradient norm before the clip (a device tensor, valid
    until the next step; None without a clip). A replay advances every
    registered host counter (:mod:`~pyhgt_tpu_torch.utils.counters`: the
    hand kernels' launches, DenseHGT's FFN calls) by what its capture
    counted."""

    def __init__(self, loss_fn: Callable[..., torch.Tensor],
                 optimizer: ScheduledOptimizer, model: nn.Module,
                 capture: bool = True):
        self.loss_fn, self.optimizer, self.model = loss_fn, optimizer, model
        self.captures = self.replays = self.eager_steps = 0
        self.grad_norm = None
        self.stream = None
        device = next(model.parameters()).device
        if (capture and device.type == "cuda"
                and _plain_adamw(optimizer.inner)
                and optimizer.norm_fn is None):
            self.device = device
            self.stream = torch.cuda.Stream(device)
            self.slots = InputSlots(device)
            self._scalars = torch.zeros(
                (len(optimizer.inner.param_groups), 3), device=device)
            self._pool = torch.cuda.graph_pool_handle()
            self._graphs = {}
            self._warm = set()      # signatures that have run eagerly
            self._refused = set()   # signatures whose capture failed

    def __call__(self, *batch):
        if self.stream is None:
            return self._eager(batch)
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            graph = self._graph_for(batch)
            if graph is None:
                loss = self._eager(batch)
            else:
                self._replay(graph)
        caller.wait_stream(self.stream)
        # a fresh loss per step: the graph's own is overwritten by the next
        return loss if graph is None else graph.loss.clone()

    def _eager(self, batch):
        """One step run as it is written: :func:`make_train_step`'s step
        where graphs do not engage, and where they do, its update in the
        graphs' form (:class:`_AdamWUpdate`), so that an eager step and a
        replay compute alike."""
        self.eager_steps += 1
        opt = self.optimizer
        opt.zero_grad()
        loss = self.loss_fn(*batch)
        loss.backward()
        update = None
        if self.stream is not None:
            try:
                update = _AdamWUpdate(opt.inner, self._scalars,
                                      make_state=True)
            except _NotCapturable:
                pass    # counts that differ: torch's update takes them
        if update is None:
            self.grad_norm = opt.step()
        else:
            self.grad_norm = self._clip()
            self._advance(update)
            update.record()
        return loss.detach()

    def _clip(self) -> Optional[torch.Tensor]:
        opt = self.optimizer
        if opt.clip_norm is None:
            return None
        return clip_by_global_norm_(opt.params, opt.clip_norm)

    def _advance(self, update: _AdamWUpdate) -> None:
        """The host's part of an update: the learning rate of
        ``schedule(count)`` (left in the groups, as an eager step leaves
        it) into ``update``'s numbers, then ``count`` advanced."""
        opt = self.optimizer
        lr = opt.schedule(opt.count)
        for group in opt.inner.param_groups:
            group["lr"] = lr
        update.advance(lr)
        opt.count += 1

    def _state(self) -> tuple:
        """What a graph bakes in of the optimizer: the clip, the
        hyperparameters, and the addresses of the parameters and of their
        state."""
        opt = self.optimizer
        out = [opt.clip_norm, id(opt.inner.state)]
        for group in opt.inner.param_groups:
            out.append(tuple(v for k, v in group.items()
                             if k not in ("params", "lr")))
            for p in group["params"]:
                out.append(p.data_ptr())
                st = opt.inner.state.get(p)
                if st:
                    out.extend(v.data_ptr() for v in st.values()
                               if torch.is_tensor(v))
        return tuple(out)

    def _graph_for(self, batch) -> Optional[_Graph]:
        """The graph that runs this call (captured now if it may be), or
        None for an eager step."""
        gen = batch[0] if batch and isinstance(batch[0],
                                               torch.Generator) else None
        key, tensors = signature(batch[1:] if gen is not None else batch)
        if key is None:
            return None
        if hooked(self.model):
            self._warm.add(key)
            return None
        ptrs = tuple(t.data_ptr() for t in tensors)
        graph = self._graphs.get((key, ptrs))
        state = self._state()
        if graph is not None:
            if graph.state != state:
                # the optimizer's state or the parameters were replaced
                # (a restored checkpoint): every graph is stale
                self._graphs.clear()
                self._warm.clear()
                return None
            return graph if graph.generator is gen else None
        if (key in self._warm and key not in self._refused
                and len(self._graphs) < MAX_GRAPHS
                and self.slots.index(tensors) is not None):
            graph = self._capture(batch, gen, key, state)
            if graph is not None:
                self._graphs[(key, ptrs)] = graph
            return graph
        self._warm.add(key)
        return None

    def _capture(self, batch, gen, key, state) -> Optional[_Graph]:
        """Record one step on ``batch`` (nothing runs); None when the
        capture fails, after which the signature stays eager."""
        opt = self.optimizer
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        before = counters.snapshot()
        torch.cuda.synchronize(self.device)
        try:
            # thread_local: the loader's threads keep pinning host memory
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                opt.zero_grad()
                loss = self.loss_fn(*batch)
                loss.backward()
                norm = self._clip()
                update = _AdamWUpdate(opt.inner, self._scalars)
                update.record()
            finally:
                graph.capture_end()
        except (RuntimeError, _NotCapturable) as e:
            warnings.warn(f"the train step could not be captured in a CUDA "
                          f"graph ({e}); its signature stays eager",
                          RuntimeWarning, stacklevel=3)
            self._refused.add(key)
            return None
        finally:
            after = counters.snapshot()
            for (obj, c), n in before.items():
                setattr(obj, c, n)
        self.captures += 1
        return _Graph(graph, loss.detach(), norm, gen, update,
                      {k: after[k] - n for k, n in before.items()}, state)

    def _replay(self, graph: _Graph) -> None:
        self._advance(graph.update)
        graph.graph.replay()
        for (obj, c), n in graph.counts.items():
            setattr(obj, c, getattr(obj, c) + n)
        self.grad_norm = graph.norm
        self.replays += 1
