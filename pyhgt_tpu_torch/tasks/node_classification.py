"""Node-classification tasks: paper-field (multi-label) & paper-venue.

Counterpart of :mod:`pyhgt_tpu.tasks.node_classification` (numpy only, the
same draws from the same generator) with the loss closure in the port's
idiom. Reference behaviour (``OAG/train_paper_field.py`` and
``train_paper_venue.py``):

- candidates = the label-side node set of one meta-relation
  (all L2 fields ``:82``; all journals for venue);
- sample ``batch_size`` targets uniformly from the split's pair dict, seed
  the sampler with their (id, time) rows (``:94-99``);
- mask label-leakage edges touching the seed block, both directions
  (``:111-122``), with
  :func:`~pyhgt_tpu_torch.sampling.hgsampler.mask_seed_edges`;
- labels: multi-hot over the candidates normalised to sum 1 per row with
  the KL loss (field, ``:133-137``), or a class index with NLL (venue);
- the head reads the first ``batch_size`` rows of the target type's block
  (``x_ids``, ``:138``): the layout puts seeds first by contract.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from pyhgt_tpu_torch.graph.csr import CSRGraph, MetaKey
from pyhgt_tpu_torch.sampling.batch import BatchLayout, pad_sample
from pyhgt_tpu_torch.sampling.hgsampler import HGSampler, mask_seed_edges
from pyhgt_tpu_torch.tasks.base import TaskBatch, TimeSplit, gather_features


@dataclasses.dataclass
class NodeClassificationTask:
    """paper-field / paper-venue style classification over seed nodes."""

    graph: CSRGraph
    sampler: HGSampler
    layout: Optional[BatchLayout]   # may be set after cap calibration
    target_type: str            # 'paper'
    label_meta: MetaKey         # ('field', 'paper', 'PF_in_L2'): label-side indexed
    batch_size: int = 256
    multi_label: bool = True    # True: KL multi-hot; False: NLL index
    feature_fn: Optional[Callable] = None

    def __post_init__(self):
        # candidate list = label-side nodes appearing as targets of the
        # label meta (cand_list, train_paper_field.py:82)
        adj = self.graph.adj[self.label_meta]
        deg = np.diff(adj.indptr)
        self.cand_list = np.where(deg > 0)[0].astype(np.int64)
        self.cand_index = {int(c): i for i, c in enumerate(self.cand_list)}
        # the target-indexed reverse of label_meta, for leakage masking
        lt, tt, rel = self.label_meta
        self.rev_label_meta: MetaKey = (
            (tt, lt, rel[len("rev_"):]) if rel.startswith("rev_")
            else (tt, lt, "rev_" + rel)
        )

    @property
    def n_classes(self) -> int:
        return len(self.cand_list)

    # ------------------------------------------------------------------
    def build_seeds(
        self,
        pairs: Dict[int, Tuple[list, int]],
        rng: np.random.Generator,
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Pick ``batch_size`` (target, time) seed rows (``:94-99``).
        Also used alone for cap calibration (``PadSpec.calibrate``)."""
        keys = np.fromiter(pairs.keys(), dtype=np.int64, count=len(pairs))
        pick = rng.choice(len(keys), min(self.batch_size, len(keys)), replace=False)
        target_ids = keys[pick]
        seeds = np.stack(
            [target_ids, np.array([pairs[int(t)][1] for t in target_ids])], axis=1
        )
        return {self.target_type: seeds}, target_ids

    def sample(
        self,
        pairs: Dict[int, Tuple[list, int]],
        split: TimeSplit,
        rng: Optional[np.random.Generator] = None,
    ) -> TaskBatch:
        rng = rng or np.random.default_rng()
        seed_dict, target_ids = self.build_seeds(pairs, rng)
        raw = self.sampler.sample_raw(
            seed_dict, rng=rng, time_max=split.max_time
        )
        n_seed = len(target_ids)
        # leakage mask: drop label edges touching the seed block, both
        # directions (train_paper_field.py:111-122)
        mask_seed_edges(raw, self.label_meta, n_seed, seed_side="src")
        mask_seed_edges(raw, self.rev_label_meta, n_seed, seed_side="tgt")

        feats = gather_features(self.graph, raw, self.feature_fn)
        sub = pad_sample(raw, self.layout, feats, rng=rng)

        C = self.n_classes
        if self.multi_label:
            y = np.zeros((self.batch_size, C), dtype=np.float32)
            for i, t in enumerate(target_ids):
                for s in pairs[int(t)][0]:
                    y[i, self.cand_index[int(s)]] = 1.0
            s = y.sum(axis=1, keepdims=True)
            y = np.divide(y, s, out=np.zeros_like(y), where=s > 0)
        else:
            y = np.zeros((self.batch_size,), dtype=np.int32)
            for i, t in enumerate(target_ids):
                y[i] = self.cand_index[int(pairs[int(t)][0][0])]
        label_mask = np.zeros(self.batch_size, dtype=bool)
        label_mask[: len(target_ids)] = True
        tids = np.full((self.batch_size,), -1, dtype=np.int64)
        tids[: len(target_ids)] = target_ids
        return TaskBatch(sub=sub, labels=y, label_mask=label_mask, target_ids=tids)

    def make_sample_fn(self, pairs, split: TimeSplit):
        """Producer for :class:`~pyhgt_tpu_torch.train.loader.PrefetchLoader`."""

        def fn(rng: np.random.Generator):
            return self.sample(pairs, split, rng)

        return fn

    # ------------------------------------------------------------------
    def make_loss_fn(self, model, em):
        """The loss of ``model`` (a seeds-head ``NodeClassifierModel``,
        whose log-probs cover the batch's seed rows) on the device of
        ``em``: KL against the normalised multi-hot labels, or NLL of the
        class index, over the live label rows.

        Returns ``loss(generator, node_feat, node_mask, se, labels,
        label_mask, edges=None)``: the forward in train mode, dropout
        masks drawn from ``generator``; ``edges`` are the raw edge arrays
        for a model that reads them (the JAX closure takes the parameters,
        a key and the raw edge arrays)."""
        from pyhgt_tpu_torch.train.step import kl_div_loss, nll_loss

        multi = self.multi_label

        def loss(generator, nf, nmk, se, labels, lmask, edges=None):
            model.train()
            logp = model(nf, nmk, se, em, generator, edges)
            if multi:
                return kl_div_loss(logp, labels, mask=lmask)
            return nll_loss(logp, labels, mask=lmask)

        return loss
