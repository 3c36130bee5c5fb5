"""The parallel modes (counterpart of :mod:`pyhgt_tpu.parallel`).

The JAX package lays devices out in a ``(data, model, graph)`` mesh (and a
``(data, pipe)`` one) and lets ``shard_map`` / GSPMD place the
collectives. Here each rank is one process with one device in a
``torch.distributed`` world (:mod:`~pyhgt_tpu_torch.parallel.distributed`),
the mesh is a layout of ranks with a process group per axis
(:mod:`~pyhgt_tpu_torch.parallel.mesh`), and each mode calls its
collectives by hand:

- data parallelism (:mod:`~pyhgt_tpu_torch.parallel.spmd`): gradients and
  loss averaged over the data group before the update;
- graph (edge-partitioned) parallelism
  (:mod:`~pyhgt_tpu_torch.parallel.edge_partition`): one batch's sorted
  edges split over the graph group, the kernels running on every shard,
  the softmax statistics, aggregations and node gradients summed across;
- pipelining (:mod:`~pyhgt_tpu_torch.parallel.pipeline`): the conv stack
  staged over the pipe group on the GPipe schedule;
- tensor parallelism (:mod:`~pyhgt_tpu_torch.parallel.mesh`'s
  ``shard_model``, :mod:`~pyhgt_tpu_torch.parallel.spmd`'s tp step): each
  model rank holds its heads' slices of the attention banks.
"""

from pyhgt_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    GRAPH_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    Mesh,
    make_mesh,
)

__all__ = ["DATA_AXIS", "GRAPH_AXIS", "MODEL_AXIS", "PIPE_AXIS", "Mesh",
           "make_mesh"]
