"""Ranking metrics — parity with the reference's ``pyHGT/utils.py:5-20``.

A copy of :mod:`pyhgt_tpu.train.metrics`: numpy on the host, computed on
gathered scores exactly as the reference does.
"""

from __future__ import annotations

import numpy as np


def dcg_at_k(r, k: int) -> float:
    """Discounted cumulative gain of relevance list ``r`` at cutoff ``k``
    (``utils.py:5-10``: log2 discount starting at rank 2)."""
    r = np.asarray(r, dtype=np.float64)[:k]
    if r.size:
        return float(np.sum(r / np.log2(np.arange(2, r.size + 2))))
    return 0.0


def ndcg_at_k(r, k: int) -> float:
    """Normalized DCG (``utils.py:12-16``)."""
    dcg_max = dcg_at_k(sorted(r, reverse=True), k)
    if not dcg_max:
        return 0.0
    return dcg_at_k(r, k) / dcg_max


def mean_reciprocal_rank(rs) -> list:
    """Per-query reciprocal rank of the first relevant item
    (``utils.py:18-20``). Returns the list (the caller averages), as the
    reference uses it."""
    out = []
    for r in rs:
        r = np.asarray(r).nonzero()[0]
        out.append(1.0 / (r[0] + 1) if r.size else 0.0)
    return out


def ranking_metrics(scores: np.ndarray, relevance: np.ndarray):
    """Batched NDCG + MRR of a [Q, C] score matrix against binary or graded
    [Q, C] relevance — the pattern every reference eval loop repeats
    (e.g. ``OAG/train_paper_field.py:265-269``)."""
    order = np.argsort(-scores, axis=1)
    sorted_rel = np.take_along_axis(relevance, order, axis=1)
    ndcgs = [ndcg_at_k(row, len(row)) for row in sorted_rel]
    mrrs = mean_reciprocal_rank(sorted_rel)
    return float(np.mean(ndcgs)), float(np.mean(mrrs))
