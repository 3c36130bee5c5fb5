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

Tensor parallelism (:func:`param_shardings` / :func:`shard_params`,
head-sharded parameter banks) is the next slice of the port and raises.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

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


def param_shardings(*_args, **_kw):
    raise NotImplementedError(
        "tensor parallelism (tp > 1: head-sharded parameter banks) is the "
        "next slice of the port")


shard_params = param_shardings


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
