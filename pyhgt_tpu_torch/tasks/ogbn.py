"""ogbn-mag node-classification task.

Counterpart of :mod:`pyhgt_tpu.tasks.ogbn`: the same draws from the same
generator (numpy only), and the masked NLL loss closure
(``make_loss_fn``).

Reference behavior (``ogbn-mag/train_ogbn_mag.py:67-102``):
seeds are papers sampled from the whole paper set with their years; after
subgraph sampling, the global split masks and labels are gathered through
the sampled node ids (``indxs``) so the loss/metric cover *all* paper nodes
in the subgraph that belong to the split — not just the seeds. The same
sampler serves train, sequential-eval, and variance-reduce-eval modes
(``:89-101``, ``eval_ogbn_mag.py:128-179``).

Graph aux requirements (set by the preprocessor,
``preprocess_ogbn_mag.py:103-123``): ``aux['y']`` int labels per paper,
``aux['years']``, and boolean ``aux['train_mask'/'valid_mask'/'test_mask']``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.sampling.batch import BatchLayout, pad_sample
from pyhgt_tpu_torch.sampling.hgsampler import HGSampler
from pyhgt_tpu_torch.tasks.base import TaskBatch, gather_features


@dataclasses.dataclass
class OgbnNodeTask:
    graph: CSRGraph
    sampler: HGSampler
    layout: BatchLayout
    target_type: str = "paper"
    batch_size: int = 128
    feature_fn: Optional[Callable] = None

    def __post_init__(self):
        aux = self.graph.aux
        self.y = np.asarray(aux["y"]).reshape(-1)
        self.years = np.asarray(aux["years"]).reshape(-1)
        self.masks = {
            k: np.asarray(aux[f"{k}_mask"]).reshape(-1).astype(bool)
            for k in ("train", "valid", "test")
        }
        self.target_nodes = np.arange(self.y.shape[0])
        self.test_nodes = np.where(self.masks["test"])[0]

    @property
    def n_classes(self) -> int:
        return int(self.y.max()) + 1

    # ------------------------------------------------------------------
    def sample(self, samp_nodes: np.ndarray, rng=None, split: str = "train") -> TaskBatch:
        """One padded batch seeded at ``samp_nodes`` (ogbn_sample parity:
        ``train_ogbn_mag.py:67-80``). ``labels[t, c]`` / ``label_mask[t, c]``
        cover the full target-type node block."""
        rng = rng or np.random.default_rng()
        seeds = np.stack([samp_nodes, self.years[samp_nodes]], axis=1)
        raw = self.sampler.sample_raw({self.target_type: seeds}, rng=rng)
        feats = gather_features(self.graph, raw, self.feature_fn)
        sub = pad_sample(raw, self.layout, feats, rng=rng)

        C = self.layout.node_cap
        ids = raw.node_ids[self.target_type][:C]
        labels = np.zeros((C,), dtype=np.int32)
        label_mask = np.zeros((C,), dtype=bool)
        labels[: len(ids)] = self.y[ids]
        label_mask[: len(ids)] = self.masks[split][ids]
        target_ids = np.full((C,), -1, dtype=np.int64)
        target_ids[: len(ids)] = ids
        return TaskBatch(
            sub=sub, labels=labels, label_mask=label_mask, target_ids=target_ids
        )

    def make_sample_fn(self, split: str = "train"):
        nodes = self.target_nodes if split == "train" else np.where(self.masks[split])[0]
        bs = self.batch_size

        def fn(rng: np.random.Generator):
            pick = rng.choice(len(nodes), bs, replace=False)
            return self.sample(nodes[pick], rng, split=split)

        return fn

    # ------------------------------------------------------------------
    def make_loss_fn(self, model, em):
        """Masked NLL over every split-member target node in the subgraph
        (the reference's train_mask pattern, ``train_ogbn_mag.py:155-160``).
        ``model`` must return log-probs for the full target-type block
        (``head_mode="full"``); ``em`` is the ``EdgeStaticMeta`` on the
        model's device.

        Returns ``loss(generator, node_feat, node_mask, se, labels,
        label_mask)``: the forward in train mode, dropout masks drawn from
        ``generator``. The JAX closure takes the parameters, a key and the
        raw edge arrays; the port's model holds its parameters and reads
        the sorted layout ``se``."""
        from pyhgt_tpu_torch.train.step import nll_loss

        def loss(generator, nf, nmk, se, labels, lmask):
            model.train()
            logp = model(nf, nmk, se, em, generator)
            return nll_loss(logp, labels, mask=lmask)

        return loss

    @staticmethod
    def accuracy(logp: np.ndarray, labels: np.ndarray, mask: np.ndarray) -> float:
        """OGB Evaluator accuracy semantics (argmax exact match)."""
        pred = np.argmax(logp, axis=-1)
        m = mask.astype(bool)
        if m.sum() == 0:
            return 0.0
        return float((pred[m] == labels[m]).mean())
