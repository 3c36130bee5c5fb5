"""Synthetic padded batches — for the smoke run, benchmarks and tests.

Counterpart of :mod:`pyhgt_tpu.utils.synth`: the same draws from the same
``numpy.random.Generator`` in the same order, so one seed gives
bit-identical arrays in both packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pyhgt_tpu_torch.ops.rte import RTE_MAX_LEN
from pyhgt_tpu_torch.sampling.batch import SubgraphBatch, TIME_SHIFT


def synth_batch(
    layout,
    rng: Optional[np.random.Generator] = None,
    din: int = 128,
    node_fill: float = 1.0,
    edge_fill: float = 1.0,
    dtype=np.float32,
) -> SubgraphBatch:
    """Random batch with ``node_fill`` of each type's capacity valid and
    ``edge_fill`` of each block's capacity carrying random valid edges
    (sorted by target within the block)."""
    rng = rng or np.random.default_rng(0)
    T, C = layout.num_types, layout.node_cap
    n_valid = max(1, int(C * node_fill))
    node_feat = np.zeros((T, C, din), dtype=dtype)
    node_feat[:, :n_valid] = rng.normal(size=(T, n_valid, din)).astype(dtype)
    node_time = np.zeros((T, C), dtype=np.int32)
    node_time[:, :n_valid] = rng.integers(1990, 2020, size=(T, n_valid))
    node_mask = np.zeros((T, C), dtype=bool)
    node_mask[:, :n_valid] = True

    E = layout.num_edges
    edge_src = np.zeros(E, np.int32)
    edge_tgt = np.zeros(E, np.int32)
    edge_dt = np.full(E, TIME_SHIFT, np.int32)
    edge_mask = np.zeros(E, bool)
    for b in layout.blocks:
        if b.meta.rel == "self":
            n_e = n_valid
            tgt_l = np.arange(n_e, dtype=np.int32)
            src_l = tgt_l
        else:
            n_e = max(1, int(b.cap * edge_fill))
            tgt_l = np.sort(rng.integers(0, n_valid, size=n_e).astype(np.int32))
            src_l = rng.integers(0, n_valid, size=n_e).astype(np.int32)
        sl = slice(b.start, b.start + n_e)
        edge_tgt[sl] = b.tgt_type_id * C + tgt_l
        edge_src[sl] = b.src_type_id * C + src_l
        dt = (
            node_time[b.tgt_type_id, tgt_l].astype(np.int64)
            - node_time[b.src_type_id, src_l].astype(np.int64)
            + TIME_SHIFT
        )
        edge_dt[sl] = np.clip(dt, 0, RTE_MAX_LEN - 1)
        edge_mask[sl] = True
    return SubgraphBatch(
        node_feat=node_feat,
        node_time=node_time,
        node_mask=node_mask,
        edge_src=edge_src,
        edge_tgt=edge_tgt,
        edge_dt=edge_dt,
        edge_mask=edge_mask,
        block_overflow=np.zeros(len(layout.blocks), np.int32),
    )


def synth_labels(
    layout, n_seed: int, n_classes: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """``n_seed`` class labels in ``[0, n_classes)``, int32, drawn from
    ``rng`` (default ``np.random.default_rng(0)``) as the JAX package's
    ``synth_labels`` draws them; ``layout`` is unread, as there."""
    rng = rng or np.random.default_rng(0)
    return rng.integers(0, n_classes, size=n_seed).astype(np.int32)
