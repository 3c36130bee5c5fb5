"""Author-disambiguation link prediction.

Counterpart of :mod:`pyhgt_tpu.tasks.link_prediction` (numpy only, the
same draws from the same generator) with the loss in the port's idiom.
Reference behaviour (``OAG/train_author_disambiguation.py``):

- candidate groups: first-author names (authors with >= 2 first-authored
  papers, ``:79-80``) shared by >= 4 author ids (``:82-86``);
- a batch samples ``batch_size // 4`` names; seeds = the groups' authors
  at ``max_time`` + their first-authored papers at their own time
  (``:104-131``);
- the leakage mask removes ``AP_write_first`` / ``rev_`` edges touching
  the seed papers (``:145-155``);
- per seed paper, the candidate row lists the true author first, then the
  same-name negatives (``:124-131``); the loss is a grouped listwise
  softmax, each group weighted by ``1 / log(group size)``
  (``mask_softmax``, ``:90-96``); scoring is the two-tower ``Matcher``.

Groups are padded to a static ``max_group`` with a candidate mask, so the
loss is one gather and one masked log-softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pyhgt_tpu_torch.graph.csr import CSRGraph, MetaKey
from pyhgt_tpu_torch.sampling.batch import BatchLayout, SubgraphBatch, pad_sample
from pyhgt_tpu_torch.sampling.hgsampler import HGSampler, mask_seed_edges
from pyhgt_tpu_torch.tasks.base import TimeSplit, gather_features


@dataclasses.dataclass
class LinkTaskBatch:
    """Padded link-prediction batch (host arrays).

    cand_idx [P, G] flat node indices of candidate authors (true first);
    cand_mask [P, G]; query_mask [P] — live seed-paper rows.
    """

    sub: SubgraphBatch
    cand_idx: np.ndarray
    cand_mask: np.ndarray
    query_mask: np.ndarray

    @property
    def batch_args(self):
        s = self.sub
        return (
            s.node_feat, s.edge_src, s.edge_tgt, s.edge_dt, s.edge_mask,
            s.node_mask,
        )


def build_name_groups(
    graph: CSRGraph,
    first_meta: MetaKey = ("author", "paper", "rev_AP_write_first"),
    name_key: str = "name",
    min_papers: int = 2,
    min_group: int = 4,
) -> Dict[str, List[int]]:
    """name -> author-id group (``:79-86``)."""
    adj = graph.adj[first_meta]
    deg = np.diff(adj.indptr)
    names = np.asarray(graph.features["author"][name_key])
    groups: Dict[str, List[int]] = {}
    for a in np.where(deg >= min_papers)[0]:
        groups.setdefault(str(names[a]), []).append(int(a))
    return {n: g for n, g in groups.items() if len(g) >= min_group}


def build_link_pairs(
    graph: CSRGraph,
    groups: Dict[str, List[int]],
    splits: Dict[str, TimeSplit],
    first_meta: MetaKey = ("author", "paper", "rev_AP_write_first"),
) -> Dict[str, Dict[str, List[Tuple[int, int, int]]]]:
    """pairs[split][name] = [(paper_id, author_pos_in_group, time), ...]."""
    adj = graph.adj[first_meta]
    out: Dict[str, Dict[str, List[Tuple[int, int, int]]]] = {k: {} for k in splits}
    for name, group in groups.items():
        for pos, a in enumerate(group):
            papers, times = adj.row(a)
            for p, t in zip(papers.tolist(), times.tolist()):
                for sname, split in splits.items():
                    if split.contains(np.array([t]))[0]:
                        out[sname].setdefault(name, []).append((int(p), pos, int(t)))
    return out


@dataclasses.dataclass
class LinkPredictionTask:
    graph: CSRGraph
    sampler: HGSampler
    layout: Optional[BatchLayout]   # may be set after cap calibration
    groups: Dict[str, List[int]]
    paper_type: str = "paper"
    author_type: str = "author"
    write_meta: MetaKey = ("paper", "author", "AP_write_first")
    batch_size: int = 256       # max seed papers (names drawn = batch_size//4)
    max_group: int = 32
    feature_fn: Optional[Callable] = None

    def build_seeds(
        self,
        pairs: Dict[str, List[Tuple[int, int, int]]],
        split: TimeSplit,
        rng: np.random.Generator,
    ) -> Tuple[Dict[str, np.ndarray], List[List[int]]]:
        """Seed assembly (``:104-131``): sampled names -> group authors at
        ``max_time`` + their first-authored papers at their own time.
        Returns (sampler seed dict, per-paper candidate rows). Also used
        alone for cap calibration (``PadSpec.calibrate``)."""
        names = list(pairs.keys())
        pick = rng.choice(len(names), min(self.batch_size // 4, len(names)), replace=False)
        max_time = split.max_time if split.max_time is not None else int(
            self.graph.times.max()
        )

        author_local: Dict[int, int] = {}
        author_info: List[List[int]] = []
        paper_info: List[List[int]] = []
        cand_rows: List[List[int]] = []
        for ni in pick:
            name = names[ni]
            group = self.groups[name]
            for a in group:
                if a not in author_local:
                    author_local[a] = len(author_local)
                    author_info.append([a, max_time])
            for p, pos, t in pairs[name]:
                if len(paper_info) >= self.batch_size:
                    break
                paper_info.append([p, t])
                # true author first, then same-name negatives (:124-131)
                row = [author_local[group[pos]]] + [
                    author_local[a] for i, a in enumerate(group) if i != pos
                ]
                cand_rows.append(row[: self.max_group])
        seed_dict = {
            self.paper_type: np.asarray(paper_info, dtype=np.int64),
            self.author_type: np.asarray(author_info, dtype=np.int64),
        }
        return seed_dict, cand_rows

    def sample(
        self,
        pairs: Dict[str, List[Tuple[int, int, int]]],
        split: TimeSplit,
        rng: Optional[np.random.Generator] = None,
    ) -> LinkTaskBatch:
        rng = rng or np.random.default_rng()
        seed_dict, cand_rows = self.build_seeds(pairs, split, rng)
        raw = self.sampler.sample_raw(
            seed_dict, rng=rng, time_max=split.max_time
        )
        n_paper_seed = len(seed_dict[self.paper_type])
        tt, st, rel = self.write_meta
        rev_meta: MetaKey = (st, tt, "rev_" + rel)
        mask_seed_edges(raw, self.write_meta, n_paper_seed, seed_side="tgt")
        mask_seed_edges(raw, rev_meta, n_paper_seed, seed_side="src")

        feats = gather_features(self.graph, raw, self.feature_fn)
        sub = pad_sample(raw, self.layout, feats, rng=rng)

        P, G = self.batch_size, self.max_group
        C = self.layout.node_cap
        a_ti = self.layout.schema.type_id(self.author_type)
        cand_idx = np.zeros((P, G), dtype=np.int32)
        cand_mask = np.zeros((P, G), dtype=bool)
        query_mask = np.zeros((P,), dtype=bool)
        for i, row in enumerate(cand_rows):
            g = len(row)
            cand_idx[i, :g] = a_ti * C + np.asarray(row, dtype=np.int32)
            cand_mask[i, :g] = True
            query_mask[i] = g >= 2
        return LinkTaskBatch(
            sub=sub, cand_idx=cand_idx, cand_mask=cand_mask, query_mask=query_mask
        )

    def make_sample_fn(self, pairs, split: TimeSplit):
        def fn(rng: np.random.Generator):
            return self.sample(pairs, split, rng)

        return fn


def grouped_listwise_loss(scores, cand_mask, query_mask):
    """The reference's ``mask_softmax`` loss (``:90-96``) on ``[P, G]``
    matcher scores: per query row, minus the log-softmax of the true
    candidate (column 0) over the row's live candidates (masked ones at
    -1e30), divided by ``log(group size)`` (at least 2), averaged over the
    live query rows (``query_mask``, any dtype)."""
    s = torch.where(cand_mask, scores, torch.full_like(scores, -1e30))
    lse = torch.logsumexp(s, dim=-1)
    gsize = torch.clamp(cand_mask.sum(dim=-1), min=2)
    per_q = -(s[:, 0] - lse) / torch.log(gsize.to(scores.dtype))
    qm = query_mask.to(scores.dtype)
    return (per_q * qm).sum() / torch.clamp(qm.sum(), min=1)


def make_link_loss_fn(model, em):
    """The grouped listwise loss of ``model`` (a ``LinkMatcherModel``) on
    the device of ``em``.

    Returns ``loss(generator, node_feat, node_mask, se, cand_idx,
    cand_mask, query_mask)``: ``model.score_pairs`` in train mode (dropout
    masks from ``generator``), then :func:`grouped_listwise_loss`. The JAX
    closure takes the parameters, a key and the raw edge arrays."""

    def loss(generator, nf, nmk, se, cand_idx, cand_mask, query_mask):
        model.train()
        scores = model.score_pairs(nf, nmk, se, em, cand_idx, generator)
        return grouped_listwise_loss(scores, cand_mask, query_mask)

    return loss
