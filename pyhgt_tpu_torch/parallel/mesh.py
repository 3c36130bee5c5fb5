"""Process meshes and the collectives the parallel modes use.

Counterpart of :mod:`pyhgt_tpu.parallel.mesh`. A JAX mesh names the axes
of an array of devices and GSPMD or ``shard_map`` inserts the collectives;
here every rank is a process, a :class:`Mesh` lays the world's ranks out
in JAX's order (``arange(world).reshape(n_data, n_model, n_graph)``), and
each rank keeps the process group of each axis it lies on. The modes call
the collectives below on those groups by hand:

- :func:`all_reduce` (sum or max) and :func:`broadcast` keep the tensor
  where it is, under ``nccl`` and under ``gloo`` alike (gloo reduces and
  broadcasts CUDA tensors itself);
- :func:`exchange` (one send to a rank and one receive from another, the
  ``ppermute`` hop), :func:`send`, :func:`recv` and :func:`all_gather`
  move CUDA tensors through pinned host memory under ``gloo``, whose
  point-to-point and gather paths take CPU tensors only; under ``nccl``
  they stay on the device.

A group of one rank is ``None`` and every collective on it is the
identity, so a single-process run needs no process group.

Tensor parallelism over the ``model`` axis is Megatron-style, with the JAX
package's rule table (:data:`_PARAM_RULES`, matched on a parameter's
trailing name): the Q/K/V banks and biases are column-parallel over
``Dout = H * dk``, the output projection ``wa`` row-parallel on its input,
the relation banks split by head, the input adapters column-parallel into
``n_hid``; everything else (norms, gates, ``ba``, RTE, DenseHGT's FFN, the
heads, the other convs) is replicated. :func:`param_shardings` names each
parameter's split axis, :func:`shard_params` cuts a full state dict into
this rank's slices, :func:`gather_params` is its inverse on the model
group's first rank, and :func:`shard_model` makes the sharded copy of a
model whose convs then run their own heads (the collectives are the
convs' and the GNN's, see :func:`gather_columns`).
"""

from __future__ import annotations

import copy
import math
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pyhgt_tpu_torch.parallel.distributed import world

DATA_AXIS = "data"
MODEL_AXIS = "model"
GRAPH_AXIS = "graph"   # edge-partition axis (parallel/edge_partition.py)
PIPE_AXIS = "pipe"     # pipeline stages (parallel/pipeline.py)


class Mesh:
    """This rank's view of a mesh of processes: ``axes`` maps each axis
    name to its size, in mesh order; the world's ranks fill the mesh in row
    major order. Every rank must build the same mesh, in the same order as
    every other mesh (the process groups are made collectively)."""

    def __init__(self, axes: Dict[str, int]):
        self.axes = dict(axes)
        names, sizes = list(self.axes), list(self.axes.values())
        rank, n = world()
        if math.prod(sizes) != n:
            raise ValueError(
                f"mesh {'x'.join(map(str, sizes))} ({', '.join(names)}) "
                f"needs {math.prod(sizes)} processes, the world has {n}")
        self.rank = rank
        self.ranks = np.arange(n).reshape(sizes)
        coords = np.unravel_index(rank, sizes)
        self.coords = {a: int(c) for a, c in zip(names, coords)}
        self._groups = {}
        for ai, axis in enumerate(names):
            rows = np.moveaxis(self.ranks, ai, -1).reshape(-1, sizes[ai])
            mine = None
            for row in rows:
                members = [int(r) for r in row]
                # every rank makes every group of the axis, members or not
                g = dist.new_group(members) if len(members) > 1 else None
                if rank in members:
                    mine = (g, members)
            self._groups[axis] = mine

    def size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 off the mesh's axes)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None: one rank)."""
        return self._groups[axis][0] if axis in self._groups else None

    def members(self, axis: str) -> list:
        """The global ranks of this rank's group along ``axis``, in axis
        order."""
        return self._groups[axis][1] if axis in self._groups else [self.rank]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              n_graph: int = 1) -> Mesh:
    """The ``(data, model, graph)`` mesh over the world (default: every
    rank on the data axis)."""
    n = world()[1]
    if n_data is None:
        n_data = n // (n_model * n_graph)
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model, GRAPH_AXIS: n_graph})


# parameter-name -> split spec (one entry per dim; the model axis where the
# parameter is cut), matched on the trailing name as the JAX package does
_PARAM_RULES = (
    # column-parallel QKV + their biases: shard Dout (= heads*dk)
    (r"(wq|wk|wv)$", (None, None, MODEL_AXIS)),
    (r"(bq|bk|bv)$", (None, MODEL_AXIS)),
    # row-parallel output projection: shard the *input* Dout axis
    (r"wa$", (None, MODEL_AXIS, None)),
    # relation banks: shard heads
    (r"(rel_att|rel_msg)$", (None, MODEL_AXIS, None, None)),
    (r"rel_pri$", (None, MODEL_AXIS)),
    # input adapters: column-parallel into n_hid
    (r"adapt_w$", (None, None, MODEL_AXIS)),
    (r"adapt_b$", (None, MODEL_AXIS)),
)


def _spec_for(name: str, leaf) -> tuple:
    """The split spec of the parameter ``name`` (a dotted
    ``named_parameters`` key) of ``leaf``'s rank: the first rule whose
    pattern matches the trailing name and whose spec has one entry per
    dim; ``()`` (replicated) otherwise."""
    last = name.rsplit(".", 1)[-1]
    for pat, spec in _PARAM_RULES:
        if re.search(pat, last) and len(spec) == leaf.dim():
            return spec
    return ()


def _axis(spec: tuple) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def param_shardings(named, mesh: Optional["Mesh"] = None
                    ) -> Dict[str, Optional[int]]:
    """The axis each parameter of ``named`` (a module, a state dict or
    ``named_parameters()`` pairs) is split on over the model axis, or None
    (replicated). The rules do not depend on ``mesh``, which the JAX
    signature carries."""
    if isinstance(named, torch.nn.Module):
        named = named.state_dict()
    items = named.items() if isinstance(named, Mapping) else named
    return {n: _axis(_spec_for(n, t)) for n, t in items}


def _model_rank(mesh: "Mesh") -> tuple:
    return mesh.index(MODEL_AXIS), mesh.size(MODEL_AXIS)


def split_along(t: torch.Tensor, axis: Optional[int], mesh: "Mesh"
                ) -> torch.Tensor:
    """This model rank's contiguous slice of ``t`` along ``axis`` (``t``
    itself when None)."""
    if axis is None:
        return t
    i, n = _model_rank(mesh)
    if t.shape[axis] % n:
        raise ValueError(f"a dim of {t.shape[axis]} does not split over "
                         f"tp = {n} model ranks")
    return t.chunk(n, dim=axis)[i].contiguous()


def join_along(t: torch.Tensor, axis: Optional[int], mesh: "Mesh"
               ) -> torch.Tensor:
    """Every model rank's slice of a tensor cut by :func:`split_along`,
    joined along ``axis`` (every rank of the model group calls it)."""
    group = mesh.group(MODEL_AXIS)
    if axis is None or group is None:
        return t
    return torch.cat(all_gather(t.contiguous(), group), dim=axis)


def shard_params(state_dict: Mapping[str, torch.Tensor], mesh: "Mesh"
                 ) -> Dict[str, torch.Tensor]:
    """This model rank's slices of a FULL state dict (a single-process
    model's, or what ``convert.flax_to_state_dict`` gives for the JAX
    parameters): the weights of a tp rank."""
    axes = param_shardings(state_dict)
    return {n: split_along(t, axes[n], mesh) for n, t in state_dict.items()}


def gather_params(model: torch.nn.Module, mesh: "Mesh"
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """The inverse of :func:`shard_params`: the full state dict of a
    sharded ``model`` on the first rank of each model group (every rank of
    the group calls it), None on the others; for checkpoints and the
    single-device evaluation."""
    sd = model.state_dict()
    axes = param_shardings(sd)
    full = {n: join_along(t, axes[n], mesh) for n, t in sd.items()}
    return full if mesh.index(MODEL_AXIS) == 0 else None


def shard_model(model: torch.nn.Module, mesh: "Mesh") -> torch.nn.Module:
    """A tensor-parallel copy of ``model`` for this rank of ``mesh``'s
    model axis: each sharded parameter cut to this rank's slice
    (:func:`shard_params`), and every submodule with a
    ``bind_model_group`` (the HGT convs, the GNN's adapters) given the
    model group, so its forward runs on its own heads or columns and makes
    the collectives that keep the rest replicated. ``model`` is left
    whole."""
    group, (_, n) = mesh.group(MODEL_AXIS), _model_rank(mesh)
    out = copy.deepcopy(model)
    axes = param_shardings(out)
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.grad = None
            if axes[name] is not None:
                p.data = split_along(p.data, axes[name], mesh).clone()
    for m in out.modules():
        if hasattr(m, "bind_model_group"):
            m.bind_model_group(group, n)
    return out


class _GatherColumns(torch.autograd.Function):
    """Forward: every model rank's columns of ``x`` joined along the last
    dim (the replicated tensor); backward: this rank's columns of the
    gradient, which every rank holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        parts = all_gather(x.contiguous(), group)
        ctx.at = dist.get_group_rank(group, dist.get_rank())
        ctx.width = x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.at * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def gather_columns(x: torch.Tensor, group) -> torch.Tensor:
    """The column-parallel ``x`` of each rank of the model ``group``
    (``[..., D / tp]``) joined into the replicated ``[..., D]``; its
    gradient is sliced back to this rank's columns. The identity on one
    rank."""
    return x if group is None else _GatherColumns.apply(x, group)


# ------------------------------------------------------------- collectives
def _backend(group) -> str:
    return dist.get_backend(group)


def _staged(t: torch.Tensor, group) -> bool:
    """gloo's point-to-point and gather paths take CPU tensors only: a CUDA
    tensor goes through pinned host memory there."""
    return t.is_cuda and _backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)   # waits for the device: the send reads it at once
    return host


def _host_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum or max of ``x`` over ``group``, in place; returns ``x``."""
    if group is None:
        return x
    rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    dist.all_reduce(x, op=rop, group=group)
    return x


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of the global rank ``src`` on every rank of ``group``, in
    place; returns ``x``."""
    if group is not None:
        dist.broadcast(x, src=src, group=group)
    return x


def exchange(x: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``x`` to the global rank ``dst`` and return the tensor of the
    same shape and dtype received from ``src`` (one ``ppermute`` hop; the
    two operations are posted together, so a ring of them cannot
    deadlock)."""
    staged = _staged(x, group)
    out = x.contiguous()
    buf = _host_like(out) if staged else torch.empty_like(out)
    if staged:
        out = _to_host(out)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, out, dst, group),
        dist.P2POp(dist.irecv, buf, src, group)])
    for r in reqs:
        r.wait()
    return buf.to(x.device, non_blocking=True) if staged else buf


def send(x: torch.Tensor, dst: int, group) -> None:
    """Send ``x`` to the global rank ``dst`` (blocks until it is taken)."""
    out = _to_host(x) if _staged(x, group) else x.contiguous()
    dist.send(out, dst, group=group)


def recv(shape: Sequence[int], dtype, device, src: int,
         group) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` sent by the global rank
    ``src``, on ``device``."""
    like = torch.empty(shape, dtype=dtype, device=device)
    staged = _staged(like, group)
    buf = _host_like(like) if staged else like
    dist.recv(buf, src, group=group)
    return buf.to(device, non_blocking=True) if staged else buf


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (same shape and dtype everywhere), in group
    order."""
    if group is None:
        return [x]
    staged = _staged(x, group)
    src = _to_host(x) if staged else x.contiguous()
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    return [o.to(x.device) for o in outs] if staged else outs
