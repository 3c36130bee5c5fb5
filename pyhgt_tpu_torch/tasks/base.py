"""Shared task machinery: temporal splits, batch assembly.

Counterpart of :mod:`pyhgt_tpu.tasks.base` (``TimeSplit``, ``TaskBatch``,
``gather_features``; numpy only). ``TaskBatch`` is a plain dataclass of
host arrays here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.sampling.batch import SubgraphBatch
from pyhgt_tpu_torch.sampling.hgsampler import RawSample


@dataclasses.dataclass(frozen=True)
class TimeSplit:
    """Half-open-ended inclusive time windows, mirroring the reference's
    train<2015 / 2015<=valid<=2016 / test>2016 convention
    (``OAG/train_paper_field.py:74-76``)."""

    lo: Optional[int] = None   # inclusive; None = -inf
    hi: Optional[int] = None   # inclusive; None = +inf

    def contains(self, t: np.ndarray) -> np.ndarray:
        m = np.ones(t.shape, dtype=bool)
        if self.lo is not None:
            m &= t >= self.lo
        if self.hi is not None:
            m &= t <= self.hi
        return m

    @property
    def max_time(self) -> Optional[int]:
        """Sampler temporal ceiling for this split (``pyHGT/data.py:127``)."""
        return self.hi


@dataclasses.dataclass
class TaskBatch:
    """SubgraphBatch + task payloads.

    ``target_ids`` maps label rows back to original graph node ids (-1 for
    padding); used host-side by the multi-sample evaluator to accumulate
    predictions per node across resamples (``eval_ogbn_mag.py:142-150``).
    """

    sub: SubgraphBatch
    labels: np.ndarray          # task-dependent shape
    label_mask: np.ndarray      # [*] bool — which label rows are live
    target_ids: np.ndarray      # [*] int64 original node ids (-1 pad)

    @property
    def batch_args(self):
        s = self.sub
        return (
            s.node_feat, s.edge_src, s.edge_tgt, s.edge_dt, s.edge_mask,
            s.node_mask,
        )


def gather_features(
    graph: CSRGraph,
    sample: RawSample,
    feature_fn: Optional[Callable] = None,
) -> Dict[str, np.ndarray]:
    """Per-type feature matrices for sampled nodes.

    Default = MAG-style row gather of the 'emb' column
    (``ogbn-mag/pyHGT/utils.py:93-106``); pass ``feature_fn(graph, type,
    ids)`` for custom assembly.
    """
    feats = {}
    for t, ids in sample.node_ids.items():
        if len(ids) == 0:
            continue
        if feature_fn is not None:
            feats[t] = feature_fn(graph, t, ids)
        else:
            cols = graph.features.get(t)
            if cols and "emb" in cols:
                feats[t] = np.asarray(cols["emb"])[ids]
    return feats
