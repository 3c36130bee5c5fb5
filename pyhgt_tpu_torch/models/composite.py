"""Composite task models: the GNN and a head wired for a downstream task.

Counterpart of :mod:`pyhgt_tpu.models.composite` (``NodeClassifierModel``;
the reference composes ``nn.Sequential(gnn, classifier)`` by hand,
``OAG/train_paper_field.py:190-195``). Parameter names match the flagship's
(``gnn.*``, ``clf.*``), so :func:`pyhgt_tpu_torch.convert.flax_to_state_dict`
carries a JAX ``NodeClassifierModel`` tree unchanged. ``representations``
and ``LinkMatcherModel`` come with link prediction.
"""

from __future__ import annotations

import torch
from torch import nn

from pyhgt_tpu_torch.models.model import GNN, Classifier

HEAD_MODES = ("seeds", "full")


class NodeClassifierModel(nn.Module):
    """GNN + log-softmax classifier.

    ``head_mode='seeds'``: classify the first ``n_seed`` rows of the target
    type's block (paper-field/venue pattern, seeds-first layout contract).
    ``head_mode='full'``: classify every row of the target type's block
    (ogbn-mag pattern — loss/metrics then mask by split membership).
    ``gnn_kwargs`` are :class:`~pyhgt_tpu_torch.models.model.GNN`'s
    arguments (:func:`pyhgt_tpu_torch.experiments.engine.gnn_kwargs`);
    weights are drawn from ``generator``.
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

    def forward(self, node_feat, node_mask, se, em, generator=None):
        h = self.gnn(node_feat, node_mask, se, em, generator)
        block = h[self.target_type_id]
        if self.head_mode == "seeds":
            block = block[: self.n_seed]
        return self.clf(block)
