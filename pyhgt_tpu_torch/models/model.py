"""GNN stack, the classifier head and the two-tower matcher.

Counterpart of :mod:`pyhgt_tpu.models.model` (``GNN``, ``Classifier``,
``Matcher``; reference ``pyHGT/model.py:3-80``), on the HGT conv only.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pyhgt_tpu_torch.models.conv import HGTConv, dropout, lecun_normal_
from pyhgt_tpu_torch.ops.hgt import typed_linear


class GNN(nn.Module):
    """Per-type input adaptation + a stack of HGT layers
    (``model.py:54-80``). The reference's per-type ``adapt_ws`` Linear loop
    is one batched ``[T,C,Din]×[T,Din,n_hid]`` matmul here. In training
    mode the adapted input drops out, as every layer's update does, with
    masks drawn from the forward's ``generator``."""

    def __init__(self, in_dim, n_hid, num_types, num_relations, n_heads,
                 n_layers, *, generator: torch.Generator, dropout=0.2,
                 prev_norm=False, last_norm=False, use_rte=True,
                 save_kv=False, edge_bf16=False, seg_pallas=False,
                 softmax_tilemax="", softmax_pallas=False,
                 edge_bwd="permute"):
        super().__init__()
        self.adapt_w = nn.Parameter(
            lecun_normal_(torch.empty(num_types, in_dim, n_hid), generator))
        self.adapt_b = nn.Parameter(torch.zeros(num_types, n_hid))
        self.dropout = dropout
        self.convs = nn.ModuleList(
            HGTConv(
                n_hid, n_hid, num_types, num_relations, n_heads,
                generator=generator, dropout=dropout,
                use_norm=last_norm if li == n_layers - 1 else prev_norm,
                use_rte=use_rte, save_kv=save_kv, edge_bf16=edge_bf16,
                seg_pallas=seg_pallas,
                softmax_tilemax=softmax_tilemax,
                softmax_pallas=softmax_pallas, edge_bwd=edge_bwd,
            )
            for li in range(n_layers)
        )

    def forward(self, node_feat, node_mask, se, em, generator=None):
        h = torch.tanh(typed_linear(node_feat, self.adapt_w, self.adapt_b))
        h = dropout(h, self.dropout, self.training, generator)
        h = h * node_mask[..., None]
        for conv in self.convs:
            h = conv(h, node_mask, se, em, generator)
        return h


def dense(n_in, n_out, generator: torch.Generator) -> nn.Linear:
    """A ``Linear`` initialized as flax's ``Dense`` (lecun_normal kernel,
    zero bias)."""
    linear = nn.Linear(n_in, n_out)
    with torch.no_grad():
        # flax kernel [in, out] = torch weight [out, in] transposed
        kernel = lecun_normal_(torch.empty(n_in, n_out), generator)
        linear.weight.copy_(kernel.T)
        linear.bias.zero_()
    return linear


class Classifier(nn.Module):
    """Linear + log_softmax head (``model.py:3-14``)."""

    def __init__(self, n_hid, n_out, *, generator: torch.Generator):
        super().__init__()
        self.linear = dense(n_hid, n_out, generator)

    def forward(self, x):
        return torch.log_softmax(self.linear(x), dim=-1)


class Matcher(nn.Module):
    """Two-tower dot-product scorer for link prediction
    (``model.py:16-49``): ``left(x) · right(y) / sqrt(n_hid)``.

    The reference caches the left tower during inference and never
    invalidates the cache (``model.py:35-39``); here caching is explicit:
    call :meth:`left` once, keep the result (or a
    :class:`~pyhgt_tpu_torch.tasks.matcher_index.MatcherIndex`), and score
    with :meth:`score_cached`."""

    def __init__(self, n_hid, *, generator: torch.Generator):
        super().__init__()
        self.n_hid = n_hid
        self.left_linear = dense(n_hid, n_hid, generator)
        self.right_linear = dense(n_hid, n_hid, generator)

    def left(self, x):
        return self.left_linear(x)

    def right(self, y):
        return self.right_linear(y)

    def score_cached(self, tx, ty):
        """``[X, Y]`` scores with a precomputed left tower ``tx``."""
        return tx @ ty.T / math.sqrt(self.n_hid)

    def forward(self, x, y):
        return self.score_cached(self.left(x), self.right(y))
