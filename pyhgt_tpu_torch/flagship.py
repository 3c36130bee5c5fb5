"""Flagship model assembly — an ogbn-mag-shaped HGT node classifier.

Counterpart of :mod:`pyhgt_tpu.flagship` on one device: schema → layout →
model → sort → log-probs of the paper seeds (serving) or their NLL loss
(training).
The graph shape mirrors ogbn-mag (paper/author/field/institution with
writes/cites/has-topic/affiliated-with + reverses); the ``bench`` preset is
the published reproduction config (4 layers, n_hid 512, 8 heads, RTE on).

``build_flagship(preset, device=None)`` builds on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from pyhgt_tpu_torch import resolve_device
from pyhgt_tpu_torch.graph.schema import GraphSchema, MetaRelation, PadSpec
from pyhgt_tpu_torch.models.model import GNN, Classifier
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.ops.sorted_hgt import EDGE_BWD
from pyhgt_tpu_torch.sampling.batch import BatchLayout, SubgraphBatch
from pyhgt_tpu_torch.sampling.sorted_batch import SortedEdges, sort_batch
from pyhgt_tpu_torch.train.step import nll_loss
from pyhgt_tpu_torch.utils.synth import synth_batch


def flagship_schema() -> GraphSchema:
    m = MetaRelation
    return GraphSchema(
        node_types=("paper", "author", "field", "institution"),
        metas=(
            m("paper", "author", "AP_write"),
            m("author", "paper", "rev_AP_write"),
            m("paper", "paper", "PP_cite"),
            m("paper", "paper", "rev_PP_cite"),
            m("field", "paper", "PF_in"),
            m("paper", "field", "rev_PF_in"),
            m("institution", "author", "in"),
            m("author", "institution", "rev_in"),
        ),
    )


@dataclasses.dataclass(frozen=True)
class FlagshipConfig:
    """The JAX package's ``FlagshipConfig``, every knob under the same
    name. ``edge_impl`` stays at the JAX default, ``"sorted"`` (the
    flagship's forward reads the sorted layout alone; the segment path is
    the GNN's, ``--edge_impl`` of the runners). ``graph_axis`` and
    ``gp_overlap`` run the convs edge-partitioned over the ranks of a
    process group (:meth:`Flagship.partition`, ``pe=`` of the forward);
    ``remat`` and ``param_bf16`` are not ported."""

    node_cap: int
    edge_cap: int
    in_dim: int
    n_hid: int
    n_heads: int
    n_layers: int
    n_classes: int
    n_seed: int
    dropout: float = 0.2
    save_kv: bool = False      # keep the gathered per-edge K/V for the
    # backward: 2 E×D saved buffers for 2 fewer backward gathers per layer
    edge_bf16: bool = False    # per-edge stage in bf16, sums in f32
    edge_bwd: str = "permute"  # the edge stage's backward strategy:
    # permute | recompute | src_direct | slab (ops/sorted_hgt._edge_bwd)
    seg_pallas: bool = False   # wide segment sums through live_partials
    softmax_pallas: bool = False  # segment softmax through the
    # segment_softmax_partials kernel; needs the legacy target aux
    # (seg_rank_cap=0), else the next softmax form runs, as in the JAX package
    seg_tile: int = 0          # kernel aux tile K (0 = ops.pallas_seg.PK)
    seg_w: int = 0             # kernel aux output block W (0 = K)
    src_rank_cap: int = 0      # src grouping: singleton-split aux (degree-1
    # sources bypass the kernel via a gather); falls back per batch
    src_split_cap: int = 0     # src grouping: two-region aux (meta blocks
    # rank-capped at this value, the self-block tail through a plain CSR);
    # needs the meta capacities tile-aligned, else falls back
    tab_cap: int = 0           # per-block occupied-Δt compaction of the
    # RTE tables (falls back per batch if a block occupies more slots)
    softmax_tilemax: str = ""  # "" | "on" | "auto": per-tile-max online
    # softmax, unguarded or with a per-batch check of the logit spread
    seg_rank_cap: int = 0      # tgt kernel aux rank cap V (0 = off; falls
    # back per batch to W = K if a tile holds more segments)
    graph_axis: str = ""       # "graph": edge-partitioned runs (gp > 1)
    gp_overlap: bool = False   # gp: ring all-reduce boundary exchange


PRESETS: Dict[str, FlagshipConfig] = {
    # quick check
    "tiny": FlagshipConfig(
        node_cap=128, edge_cap=256, in_dim=128, n_hid=128,
        n_heads=4, n_layers=2, n_classes=16, n_seed=32,
    ),
    # the ogbn-mag reproduction scale (ogbn-mag README: depth 6 width 520
    # -> ~3248 nodes/type; 4x512x8 model) with the JAX package's bench flags
    "bench": FlagshipConfig(
        node_cap=3328, edge_cap=26624, in_dim=512, n_hid=512,
        n_heads=8, n_layers=4, n_classes=349, n_seed=128,
        save_kv=True, edge_bf16=True, seg_pallas=True, seg_rank_cap=64, tab_cap=64,
        softmax_tilemax="on",
    ),
}


class FlagshipModel(nn.Module):
    """GNN + Classifier over the paper-seed slice (the composition the
    reference training scripts build by hand, ``ogbn-mag/
    train_ogbn_mag.py:109-116``)."""

    def __init__(self, cfg: FlagshipConfig, num_types: int,
                 num_relations: int, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.gnn = GNN(
            cfg.in_dim, cfg.n_hid, num_types, num_relations, cfg.n_heads,
            cfg.n_layers, generator=generator, dropout=cfg.dropout,
            conv_name="hgt", prev_norm=True, last_norm=True, use_rte=True,
            edge_impl="sorted",
            save_kv=cfg.save_kv, edge_bf16=cfg.edge_bf16, seg_pallas=cfg.seg_pallas,
            softmax_tilemax=cfg.softmax_tilemax,
            softmax_pallas=cfg.softmax_pallas, edge_bwd=cfg.edge_bwd,
            graph_axis=cfg.graph_axis, gp_overlap=cfg.gp_overlap,
        )
        self.clf = Classifier(cfg.n_hid, cfg.n_classes, generator=generator)

    def forward(self, node_feat, node_mask, se, em, generator=None, pe=None):
        return self.head(self.gnn(node_feat, node_mask, se, em, generator,
                                  pe=pe))

    def head(self, h):
        seeds = h[0, : self.cfg.n_seed]  # paper seeds come first by contract
        return self.clf(seeds)


@dataclasses.dataclass
class Flagship:
    cfg: FlagshipConfig
    schema: GraphSchema
    layout: BatchLayout
    em: EdgeStaticMeta         # host arrays (the sort reads them)
    model: FlagshipModel       # on ``device``
    device: torch.device
    seed: int = 0

    def __post_init__(self):
        self.em_dev = self.em.to(self.device)
        # the dropout masks' own stream, on the model's device
        self.dropout_gen = torch.Generator(device=self.device)
        self.dropout_gen.manual_seed(self.seed)

    def sort(self, batch: SubgraphBatch, with_backward: bool = True
             ) -> SortedEdges:
        """Host-side sort + aux of one batch (the C++ batch prep when its
        library builds, else numpy; the same arrays either way);
        ``with_backward=False`` leaves out what only a training step
        reads. Under ``graph_axis`` the caps are left to
        :meth:`partition`, which applies them per shard."""
        c = self.cfg
        gp = bool(c.graph_axis)
        return sort_batch(batch, self.layout, self.em,
                          pk=c.seg_tile or None, pw=c.seg_w or None,
                          tgt_rank_cap=0 if gp else c.seg_rank_cap,
                          src_rank_cap=0 if gp else c.src_rank_cap,
                          tab_cap=0 if gp else c.tab_cap,
                          src_split_cap=0 if gp else c.src_split_cap,
                          with_backward=with_backward)

    def partition(self, se: SortedEdges, n_parts: int):
        """:meth:`sort`'s batch cut into ``n_parts`` contiguous shards, each
        with its own aux and the preset's ``tab_cap`` / ``seg_rank_cap``
        (:func:`~pyhgt_tpu_torch.parallel.edge_partition.partition_sorted`)."""
        from pyhgt_tpu_torch.parallel.edge_partition import partition_sorted

        c, lay = self.cfg, self.layout
        return partition_sorted(
            se, n_parts, num_blocks=len(lay.blocks), node_cap=lay.node_cap,
            num_nodes_flat=lay.num_types * lay.node_cap,
            pk=c.seg_tile or None, pw=c.seg_w or None,
            tgt_rank_cap=c.seg_rank_cap, tab_cap=c.tab_cap)

    def to_device(self, batch: SubgraphBatch, se: SortedEdges, labels=None):
        """``(batch, se, labels)`` with what the model reads as tensors on
        the model's device, so a loop over one batch copies it once."""
        dev = self.device
        batch = dataclasses.replace(
            batch, node_feat=torch.as_tensor(batch.node_feat, device=dev),
            node_mask=torch.as_tensor(batch.node_mask, device=dev))
        if labels is not None:
            labels = torch.as_tensor(labels, device=dev).long()
        return batch, se.to(dev), labels

    def _logp(self, batch, se):
        return self.model(batch.node_feat, batch.node_mask, se, self.em_dev,
                          generator=self.dropout_gen)

    @torch.no_grad()
    def forward(self, batch: SubgraphBatch, se: SortedEdges = None):
        """Log-probs ``[n_seed, n_classes]`` of one batch, on the model's
        device, in eval mode (``se``: the batch's :meth:`sort`, made here
        if absent)."""
        se = self.sort(batch, with_backward=False) if se is None else se
        self.model.eval()
        return self._logp(*self.to_device(batch, se)[:2])

    def loss(self, batch: SubgraphBatch, se, labels):
        """The training loss of one batch (the JAX package's
        ``loss_fn_single``): the forward in train mode, with dropout masks
        from this flagship's seeded generator, and the NLL of the seeds'
        labels. ``batch``, ``se`` and ``labels`` may be host arrays or
        :meth:`to_device`'s tensors; ``se`` may be this rank's
        :class:`~pyhgt_tpu_torch.parallel.edge_partition.EdgeShard` (the
        convs then run edge-partitioned)."""
        self.model.train()
        batch, se, labels = self.to_device(batch, se, labels)
        return nll_loss(self._logp(batch, se), labels)


def build_flagship(preset: str = "tiny", device=None, seed: int = 0,
                   **overrides) -> Flagship:
    """The flagship model with weights drawn from ``seed``, on ``device``
    (default ``cuda``; raises if there is none)."""
    dev = resolve_device(device)
    cfg = PRESETS[preset]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.edge_bwd not in EDGE_BWD:
        raise ValueError(f"edge_bwd {cfg.edge_bwd!r} not in {EDGE_BWD}")
    if cfg.softmax_tilemax not in ("", "on", "auto"):
        raise ValueError(f"softmax_tilemax {cfg.softmax_tilemax!r} not in "
                         "('', 'on', 'auto')")
    schema = flagship_schema()
    pad = PadSpec(node_cap=cfg.node_cap, default_edge_cap=cfg.edge_cap)
    layout = BatchLayout(schema=schema, pad=pad)
    em = EdgeStaticMeta.from_layout(layout)
    gen = torch.Generator().manual_seed(seed)
    model = FlagshipModel(cfg, schema.num_types, schema.num_relations,
                          generator=gen)
    model = model.to(dev).eval()
    return Flagship(cfg=cfg, schema=schema, layout=layout, em=em,
                    model=model, device=dev, seed=seed)


def synth_flagship_batch(fl: Flagship, seed: int = 0, edge_fill: float = 1.0):
    """A random full batch and seed labels, drawn as the JAX package draws
    them (same seed, same arrays)."""
    rng = np.random.default_rng(seed)
    batch = synth_batch(
        fl.layout, rng, din=fl.cfg.in_dim, node_fill=1.0, edge_fill=edge_fill
    )
    labels = rng.integers(0, fl.cfg.n_classes, size=fl.cfg.n_seed).astype(np.int32)
    return batch, labels
