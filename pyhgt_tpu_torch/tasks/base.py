"""Shared task machinery: temporal splits, pair dicts, batch assembly.

Counterpart of :mod:`pyhgt_tpu.tasks.base` (``TimeSplit``,
``build_time_split_pairs``, ``subsample_pairs``, ``TaskBatch``,
``gather_features``; numpy only). ``TaskBatch`` is a plain dataclass of
host arrays here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from pyhgt_tpu_torch.graph.container import NO_TIME
from pyhgt_tpu_torch.graph.csr import CSRGraph, MetaKey
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


def build_time_split_pairs(
    graph: CSRGraph,
    meta: MetaKey,
    splits: Dict[str, TimeSplit],
) -> Dict[str, Dict[int, Tuple[List[int], int]]]:
    """``pairs[split][target_id] = ([label_ids], time)`` from one
    meta-relation's edges, split by edge timestamp.

    ``meta`` is target-indexed: e.g. ``('paper', 'field', 'rev_PF_in_L2')``
    collects each paper's fields (the reference iterates the same relation,
    ``OAG/train_paper_field.py:161-177``; like the reference, a target whose
    edges span splits keeps the *last seen* time per split). Untimed edges
    are excluded — the reference's if/elif chain silently dumps them into
    the TEST split (``:165-177``), which is an accident not copied.
    """
    adj = graph.adj[meta]
    out: Dict[str, Dict[int, Tuple[List[int], int]]] = {k: {} for k in splits}
    n_tgt = adj.indptr.shape[0] - 1
    for tgt in range(n_tgt):
        lo, hi = adj.indptr[tgt], adj.indptr[tgt + 1]
        if lo == hi:
            continue
        srcs = adj.src[lo:hi]
        times = adj.time[lo:hi]
        timed = times != NO_TIME
        for name, split in splits.items():
            m = split.contains(times) & timed
            if not m.any():
                continue
            cell = out[name].get(tgt)
            if cell is None:
                out[name][tgt] = (srcs[m].tolist(), int(times[m][-1]))
            else:
                cell[0].extend(srcs[m].tolist())
    return out


def subsample_pairs(pairs, fraction: float, seed: int = 43):
    """``--data_percentage`` semantics with the reference's fixed seed 43
    (``OAG/train_paper_field.py:179-184``): a ``RandomState(seed)`` draw."""
    if fraction >= 1.0:
        return pairs
    rng = np.random.RandomState(seed)
    keys = list(pairs.keys())
    keep = rng.choice(len(keys), int(len(keys) * fraction), replace=False)
    return {keys[i]: pairs[keys[i]] for i in keep}


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
