"""Fixed-shape padded batches — the host layout the model reads.

Counterpart of :mod:`pyhgt_tpu.sampling.batch`. A :class:`BatchLayout`
(schema + PadSpec) fixes every array shape once per config:

- nodes pack type-contiguously into ``[T, C, D]`` (each type padded to the
  same capacity ``C``);
- edges pack into flat arrays with one *static* block per meta-relation plus
  one 'self' block per type (the reference appends a ``'self'`` loop per
  node, ``pyHGT/data.py:183-186``);
- ``edge_dt = t_tgt - t_src + 120`` clipped to [0, 240), matching
  ``pyHGT/data.py:247-250`` and the RTE table size (``pyHGT/conv.py:287``).

``pad_sample`` (sampler output -> batch) arrives with the sampler.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pyhgt_tpu_torch.graph.schema import GraphSchema, PadSpec

TIME_SHIFT = 120   # pyHGT/data.py:250 — "time ranges 1900-2020, largest span is 120"


@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """Static (hashable) description of the padded batch arrays."""

    schema: GraphSchema
    pad: PadSpec

    def __post_init__(self):
        blocks, num_edges = self.schema.build_blocks(self.pad)
        object.__setattr__(self, "blocks", blocks)
        object.__setattr__(self, "num_edges", num_edges)

    @property
    def num_types(self) -> int:
        return self.schema.num_types

    @property
    def node_cap(self) -> int:
        return self.pad.node_cap

    @property
    def num_nodes_flat(self) -> int:
        return self.schema.num_types * self.pad.node_cap


@dataclasses.dataclass
class SubgraphBatch:
    """One padded subgraph as host numpy arrays.

    Shapes (T = num types, C = node cap, E = total edge cap, B = #blocks):
      node_feat [T, C, Din] f32 | node_time [T, C] i32 | node_mask [T, C] bool
      edge_src/edge_tgt [E] i32 (flat node indices)     | edge_dt [E] i32
      edge_mask [E] bool | block_overflow [B] i32 (diagnostics)
    """

    node_feat: np.ndarray
    node_time: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_tgt: np.ndarray
    edge_dt: np.ndarray
    edge_mask: np.ndarray
    block_overflow: np.ndarray
