"""Composite task models: the GNN and a head wired for a downstream task.

Counterpart of :mod:`pyhgt_tpu.models.composite` (``NodeClassifierModel``
with ``representations``, ``LinkMatcherModel``; the reference composes
``nn.Sequential(gnn, classifier)`` and GNN + Matcher by hand,
``OAG/train_paper_field.py:190-195``, ``train_author_disambiguation.py``).
Parameter names follow the flax trees (``gnn.*``, ``clf.*``,
``matcher.left_linear.*`` / ``matcher.right_linear.*``), so
:func:`pyhgt_tpu_torch.convert.flax_to_state_dict` carries a JAX model's
tree across.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pyhgt_tpu_torch.models.model import GNN, Classifier, Matcher

HEAD_MODES = ("seeds", "full")


class NodeClassifierModel(nn.Module):
    """GNN + log-softmax classifier.

    ``head_mode='seeds'``: classify the first ``n_seed`` rows of the target
    type's block (paper-field/venue pattern, seeds-first layout contract).
    ``head_mode='full'``: classify every row of the target type's block
    (ogbn-mag pattern — loss/metrics then mask by split membership).
    ``gnn_kwargs`` are :class:`~pyhgt_tpu_torch.models.model.GNN`'s
    arguments (:func:`pyhgt_tpu_torch.experiments.engine.gnn_kwargs`);
    weights are drawn from ``generator``. ``edges``, the raw edge arrays,
    and ``pe``, a rank's shard of an edge-partitioned batch, go to the GNN
    as its ``forward`` describes.
    """

    def __init__(self, gnn_kwargs: dict, n_classes: int,
                 target_type_id: int = 0, head_mode: str = "seeds",
                 n_seed: int = 0, *, generator: torch.Generator):
        super().__init__()
        if head_mode not in HEAD_MODES:
            raise ValueError(f"head_mode {head_mode!r} not in {HEAD_MODES}")
        self.target_type_id, self.head_mode = target_type_id, head_mode
        self.n_seed = n_seed
        self.gnn = GNN(**gnn_kwargs, generator=generator)
        self.clf = Classifier(gnn_kwargs["n_hid"], n_classes,
                              generator=generator)

    def forward(self, node_feat, node_mask, se, em, generator=None,
                edges=None, pe=None):
        return self.head(self.gnn(node_feat, node_mask, se, em, generator,
                                  edges, pe=pe))

    def head(self, h):
        """Log-probs from the GNN's output ``h [T, C, n_hid]``."""
        block = h[self.target_type_id]
        if self.head_mode == "seeds":
            block = block[: self.n_seed]
        return self.clf(block)

    def representations(self, node_feat, node_mask, se, em, generator=None,
                        edges=None, pe=None):
        """The GNN's ``[T, C, n_hid]`` node representations."""
        return self.gnn(node_feat, node_mask, se, em, generator, edges,
                        pe=pe)


class LinkMatcherModel(nn.Module):
    """GNN + two-tower Matcher for grouped link prediction (author
    disambiguation: queries = seed papers, candidates = same-name authors;
    ``train_author_disambiguation.py:293-294``)."""

    def __init__(self, gnn_kwargs: dict, n_hid: int, query_type_id: int = 0,
                 n_query: int = 0, *, generator: torch.Generator):
        super().__init__()
        self.n_hid, self.query_type_id = n_hid, query_type_id
        self.n_query = n_query      # seed papers per batch (static)
        self.gnn = GNN(**gnn_kwargs, generator=generator)
        self.matcher = Matcher(n_hid, generator=generator)

    def forward(self, *args, **kwargs):
        return self.score_pairs(*args, **kwargs)

    def score_pairs(self, node_feat, node_mask, se, em, cand_idx,
                    generator=None, edges=None, pe=None):
        """``[P, G]`` matcher scores: the query papers (the first
        ``n_query`` rows of the query type's block) against each row's
        candidates (``cand_idx``: rows of the flattened ``[T * C, D]``
        output).

        Candidates go through the *left* tower (the side the reference
        caches for million-candidate serving, ``pyHGT/model.py:27-39``),
        queries through the right."""
        return self.head(self.gnn(node_feat, node_mask, se, em, generator,
                                  edges, pe=pe), cand_idx)

    def head(self, h, cand_idx):
        """Matcher scores from the GNN's output ``h [T, C, n_hid]``."""
        T, C, D = h.shape
        flat = h.reshape(T * C, D)
        q = self.matcher.right(h[self.query_type_id, : self.n_query])
        cands = self.matcher.left(flat[cand_idx.long()])     # [P, G, D]
        scores = torch.einsum("pd,pgd->pg", q, cands)
        return scores / math.sqrt(self.n_hid)
