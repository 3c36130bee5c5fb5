"""GNN stack, the classifier head and the two-tower matcher.

Counterpart of :mod:`pyhgt_tpu.models.model` (``GNN``, ``Classifier``,
``Matcher``; reference ``pyHGT/model.py:3-80``), with every conv of
:func:`pyhgt_tpu_torch.models.conv.general_conv` on either edge path.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pyhgt_tpu_torch.models.conv import (
    dense,
    dropout,
    general_conv,
    lecun_normal_,
)
from pyhgt_tpu_torch.ops.hgt import typed_linear
from pyhgt_tpu_torch.parallel.edge_partition import EdgeShard

# the convs whose attention rides the sorted edge path when asked to
SORTED_CONVS = ("hgt", "dense_hgt")


class GNN(nn.Module):
    """Per-type input adaptation + a stack of ``general_conv`` layers
    (``model.py:54-80``). The reference's per-type ``adapt_ws`` Linear loop
    is one batched ``[T,C,Din]×[T,Din,n_hid]`` matmul here. ``conv_name``
    and ``edge_impl`` default to the JAX package's ``"hgt"`` and
    ``"segment"``. In training mode the adapted input drops out, as every
    layer's update does, with masks drawn from the forward's
    ``generator``.

    ``forward(node_feat, node_mask, se, em, generator=None, edges=None)``:
    ``se`` is the sorted layout, which HGT and DenseHGT read on the sorted
    path; ``edges = (edge_src, edge_tgt, edge_dt, edge_mask)`` are the raw
    edge arrays, which the segment path and the other convs read
    (:attr:`reads_edges`). The JAX ``__call__`` takes both the same way; a
    caller whose model does not read the raw arrays may leave them out, so
    the sorted HGT path copies nothing more to the device than before.

    ``graph_axis="graph"`` (the JAX ``graph_axis``; ``gp_overlap`` its ring
    form) lets the HGT convs run edge-partitioned: ``forward(...,
    pe=shard)`` with this rank's
    :class:`~pyhgt_tpu_torch.parallel.edge_partition.EdgeShard` (or the
    shard in ``se``'s place, so a task's loss passes it unchanged). The dropout masks are then drawn alike on every rank of the
    graph group (the caller seeds their ``generator`` alike), as
    ``shard_map`` shares the rng along ``graph``."""

    def __init__(self, in_dim, n_hid, num_types, num_relations, n_heads,
                 n_layers, *, generator: torch.Generator, dropout=0.2,
                 conv_name="hgt", prev_norm=False, last_norm=False,
                 use_rte=True, edge_impl="segment", save_kv=False,
                 edge_bf16=False, seg_pallas=False, softmax_tilemax="",
                 softmax_pallas=False, edge_bwd="permute", graph_axis="",
                 gp_overlap=False):
        super().__init__()
        self.conv_name, self.edge_impl = conv_name, edge_impl
        self.reads_edges = (conv_name not in SORTED_CONVS
                            or edge_impl == "segment")
        self.adapt_w = nn.Parameter(
            lecun_normal_(torch.empty(num_types, in_dim, n_hid), generator))
        self.adapt_b = nn.Parameter(torch.zeros(num_types, n_hid))
        self.dropout = dropout
        self.convs = nn.ModuleList(
            general_conv(
                conv_name, n_hid, n_hid, num_types, num_relations, n_heads,
                generator=generator, dropout=dropout,
                use_norm=last_norm if li == n_layers - 1 else prev_norm,
                use_rte=use_rte, edge_impl=edge_impl, save_kv=save_kv,
                edge_bf16=edge_bf16, seg_pallas=seg_pallas,
                softmax_tilemax=softmax_tilemax,
                softmax_pallas=softmax_pallas, edge_bwd=edge_bwd,
                graph_axis=graph_axis, gp_overlap=gp_overlap,
            )
            for li in range(n_layers)
        )

    def embed(self, node_feat, node_mask, generator=None):
        """The adapted input: per-type linear, tanh, dropout, node mask."""
        h = torch.tanh(typed_linear(node_feat, self.adapt_w, self.adapt_b))
        h = dropout(h, self.dropout, self.training, generator)
        return h * node_mask[..., None]

    def forward(self, node_feat, node_mask, se, em, generator=None,
                edges=None, pe=None):
        if pe is None and isinstance(se, EdgeShard):
            se, pe = None, se
        h = self.embed(node_feat, node_mask, generator)
        for conv in self.convs:
            h = conv(h, node_mask, se, em, generator, edges, pe=pe)
        return h


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
