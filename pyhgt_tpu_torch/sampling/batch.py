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

:func:`pad_sample` packs a sampler's ragged output into that layout, with
the JAX package's draws for edge overflow (bit-identical arrays from the
same generator state).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np

from pyhgt_tpu_torch.graph.schema import GraphSchema, PadSpec
from pyhgt_tpu_torch.ops.rte import RTE_MAX_LEN
from pyhgt_tpu_torch.sampling.hgsampler import RawSample

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

    def flat_index(self, node_type: str, local: np.ndarray) -> np.ndarray:
        """Flat node index of local ids within a type block."""
        return self.schema.type_id(node_type) * self.pad.node_cap + local

    def seed_slice(self, node_type: str, num_seeds: int) -> np.ndarray:
        """Flat indices of the first ``num_seeds`` nodes of a type (the task
        heads read their outputs there, cf. ``OAG/train_paper_field.py:138``)."""
        return self.flat_index(node_type, np.arange(num_seeds))


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


class _PadCounts:
    """What :func:`pad_sample` packed, counted under a lock (the loader's
    threads pad at once): ``batches`` padded, valid node ``rows`` filled and
    node rows ``truncated`` beyond the layout's ``node_cap``, which stays 0
    while the cap holds HGSampling's bound (``schema.sampler_node_bound``).
    Not replayed by a CUDA graph: it counts host work."""

    def __init__(self):
        self._lock = threading.Lock()
        self.batches = self.rows = self.truncated = 0

    def add(self, rows: int, truncated: int):
        with self._lock:
            self.batches += 1
            self.rows += rows
            self.truncated += truncated

    def read(self):
        """``(batches, rows, truncated)`` so far."""
        with self._lock:
            return self.batches, self.rows, self.truncated


pad_counts = _PadCounts()


def pad_sample(
    sample: RawSample,
    layout: BatchLayout,
    features: Dict[str, np.ndarray],
    rng: Optional[np.random.Generator] = None,
    feat_dtype=np.float32,
) -> SubgraphBatch:
    """Pack a RawSample into the fixed-shape SubgraphBatch.

    ``features[type]`` is the ``[n_type, Din]`` feature matrix for the
    sampled nodes of that type (same order as ``sample.node_ids[type]``).
    Node overflow beyond ``node_cap`` truncates (keeping seeds, which come
    first; counted in :data:`pad_counts`); edge overflow per block keeps a
    uniform random subset and records the drop count in ``block_overflow``.
    """
    schema, pad = layout.schema, layout.pad
    T, C = schema.num_types, pad.node_cap
    din = next(iter(features.values())).shape[-1] if features else 0

    node_feat = np.zeros((T, C, din), dtype=feat_dtype)
    node_time = np.zeros((T, C), dtype=np.int32)
    node_mask = np.zeros((T, C), dtype=bool)
    counts: Dict[str, int] = {}
    truncated = 0
    for t in schema.node_types:
        ids = sample.node_ids.get(t)
        n = 0 if ids is None else min(len(ids), C)
        counts[t] = n
        truncated += 0 if ids is None else len(ids) - n
        if n == 0:
            continue
        ti = schema.type_id(t)
        node_time[ti, :n] = sample.node_time[t][:n]
        node_mask[ti, :n] = True
        if t in features:
            node_feat[ti, :n] = features[t][:n]

    E = layout.num_edges
    edge_src = np.zeros(E, dtype=np.int32)
    edge_tgt = np.zeros(E, dtype=np.int32)
    edge_dt = np.full(E, TIME_SHIFT, dtype=np.int32)
    edge_mask = np.zeros(E, dtype=bool)
    overflow = np.zeros(len(layout.blocks), dtype=np.int32)

    for bi, blk in enumerate(layout.blocks):
        if blk.meta.rel == "self":
            n = counts.get(blk.meta.tgt_type, 0)
            loc = np.arange(n, dtype=np.int32)
            tgt_l, src_l = loc, loc
        else:
            e = sample.edges.get(blk.meta.as_tuple())
            if e is None:
                continue
            tgt_l, src_l = e
            # drop edges touching truncated nodes
            keep = (tgt_l < counts.get(blk.meta.tgt_type, 0)) & (
                src_l < counts.get(blk.meta.src_type, 0)
            )
            tgt_l, src_l = tgt_l[keep], src_l[keep]
            if len(tgt_l) > blk.cap:
                overflow[bi] = len(tgt_l) - blk.cap
                r = rng or np.random.default_rng()
                pick = r.choice(len(tgt_l), blk.cap, replace=False)
                tgt_l, src_l = tgt_l[pick], src_l[pick]
        n = len(tgt_l)
        if n == 0:
            continue
        # sort by target for segment locality (softmax/scatter coherence)
        order = np.argsort(tgt_l, kind="stable")
        tgt_l, src_l = tgt_l[order], src_l[order]
        tt, st = blk.tgt_type_id, blk.src_type_id
        sl = slice(blk.start, blk.start + n)
        edge_tgt[sl] = tt * C + tgt_l
        edge_src[sl] = st * C + src_l
        dt = (
            node_time[tt, tgt_l].astype(np.int64)
            - node_time[st, src_l].astype(np.int64)
            + TIME_SHIFT
        )
        edge_dt[sl] = np.clip(dt, 0, RTE_MAX_LEN - 1).astype(np.int32)
        edge_mask[sl] = True

    pad_counts.add(sum(counts.values()), truncated)
    return SubgraphBatch(
        node_feat=node_feat,
        node_time=node_time,
        node_mask=node_mask,
        edge_src=edge_src,
        edge_tgt=edge_tgt,
        edge_dt=edge_dt,
        edge_mask=edge_mask,
        block_overflow=overflow,
    )


def stack_batches(batches) -> SubgraphBatch:
    """Stack same-layout batches along a new leading axis (data
    parallelism)."""
    return SubgraphBatch(**{
        f.name: np.stack([getattr(b, f.name) for b in batches], axis=0)
        for f in dataclasses.fields(SubgraphBatch)})
