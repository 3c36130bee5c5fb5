"""Edge-partitioned HGT: the graph analogue of sequence parallelism.

Counterpart of :mod:`pyhgt_tpu.parallel.edge_partition`. One large
subgraph is split over the ranks of a ``graph`` axis:

- the target-sorted edge array splits into contiguous slices, and each
  slice gets the full production aux (the tiled-reduction aux, the kernel
  aux of the three groupings, the src/tab permutations, the tab window)
  from the same pack stage the single-device batch uses
  (:func:`~pyhgt_tpu_torch.sampling.sorted_batch._pack_sorted`), so each
  rank runs the production edge stage on its shard: the ``live_partials``
  and ``live_partials_pair`` kernels, the bf16 edge stage, ``save_kv``;
- node-level tensors (queries, the relation-transformed K/V banks, the RTE
  tables) are replicated on every rank of the axis: they are O(N·D), the
  edges O(E·D);
- the softmax statistics cross the shards with one max and one sum of
  ``[N, H]``, the partial ``[N, D]`` aggregations are summed once per
  layer, and the backward adds one ``[N, H]`` sum for the softmax Jacobian
  and one sum of the node-level tensors' gradients. All of it lives in
  :func:`pyhgt_tpu_torch.ops.sorted_hgt.hgt_conv_core_sorted` behind its
  ``graph_group`` argument, optionally as rings (``gp_overlap``).

Composes with data parallelism: each data rank's graph group partitions its
own batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from pyhgt_tpu_torch.ops.pallas_seg import PK as _PK, PW as _PW
from pyhgt_tpu_torch.ops.rte import RTE_MAX_LEN
from pyhgt_tpu_torch.ops.sorted_hgt import hgt_conv_core_sorted
from pyhgt_tpu_torch.sampling.sorted_batch import (
    SortedEdges,
    _native_batch,
    _pack_sorted,
)


@dataclasses.dataclass
class PartitionedEdges:
    """One batch's :class:`SortedEdges` cut into ``len(shards)``
    contiguous slices, each with its own aux (host arrays)."""

    shards: Tuple[SortedEdges, ...]

    def to(self, device) -> "PartitionedEdges":
        return PartitionedEdges(tuple(s.to(device) for s in self.shards))

    def local(self, index: int, group) -> "EdgeShard":
        """The shard the rank at ``index`` of the graph ``group`` holds."""
        return EdgeShard(se=self.shards[index], group=group)


@dataclasses.dataclass
class EdgeShard:
    """A rank's shard of a :class:`PartitionedEdges` and the graph-axis
    process group whose ranks hold the other shards (the JAX package's
    local block inside ``shard_map``). ``group`` None: a world of one rank,
    where the shard is the whole batch."""

    se: SortedEdges
    group: object = None

    def to(self, device) -> "EdgeShard":
        return dataclasses.replace(self, se=self.se.to(device))


def _caps_of(se: SortedEdges):
    """What the caps decided for a shard: the table space compacted, and
    the target aux's rank cap."""
    return se.tab_sel is not None, se.pseg_tgt.v


def partition_sorted(se: SortedEdges, n_parts: int, num_blocks: int,
                     node_cap: int, num_nodes_flat: int,
                     pk: Optional[int] = None, pw: Optional[int] = None,
                     tgt_rank_cap: int = 0,
                     tab_cap: int = 0) -> PartitionedEdges:
    """Split a target-sorted edge view into ``n_parts`` contiguous slices,
    each padded to the kernel tile and packed with the full production aux
    (host side, the C++ pack when its library builds, else numpy: slices
    of a sorted array are sorted, so every per-shard builder is the
    single-device one).

    ``tab_cap`` / ``tgt_rank_cap`` apply per shard: each slice compacts
    its own occupied (block, Δt) table space and builds its own
    rank-capped target aux. If any shard violates a cap, the whole batch
    falls back for that cap (all-or-none, as in the JAX package), the tab
    cap first: every rank then takes the same softmax route. Other aux may
    differ between shards (a shard whose tiles span more than two meta
    blocks has no tab-window aux): each rank runs its own program, where
    the JAX package's stacked shards must share one layout and it raises.
    ``se`` must be uncompacted (built with ``tab_cap=0`` and
    ``src_split_cap=0``): the per-shard aux is rebuilt from ``se.tabidx``
    in the full ``B * L`` table space."""
    PKv = pk or _PK
    PWv = pw or (pk or _PW)
    if se.tab_sel is not None or se.src_cut:
        raise ValueError(
            "partition_sorted needs an UNCOMPACTED SortedEdges: per-shard "
            "aux is rebuilt from se.tabidx assuming the full B*L tab space "
            "and unsplit src space; build the batch with tab_cap=0 / "
            "src_split_cap=0 when gp > 1 and pass tab_cap here instead")
    E = se.edge_tgt.shape[0]
    if E % n_parts:
        raise ValueError(f"E={E} not divisible by n_parts={n_parts}")
    Ep = E // n_parts
    padn = (-Ep) % PKv
    N, B, C, L = num_nodes_flat, num_blocks, node_cap, RTE_MAX_LEN
    R = se.rel_onehot.shape[-1]
    nb = _native_batch()

    def sl(a, p):
        return np.asarray(a[p * Ep:(p + 1) * Ep])

    def pack(p, tab_cap_, rank_cap_):
        src, tgt, mask = sl(se.edge_src, p), sl(se.edge_tgt, p), \
            sl(se.edge_mask, p)
        gidx, tabidx = sl(se.gidx, p), sl(se.tabidx, p)
        onehot = sl(se.rel_onehot, p)
        key = np.where(mask, tgt, N).astype(np.int32)
        if padn:
            # pad each shard to the kernel tile (the sort's convention:
            # masked rows land in the last block's last slot)
            src = np.concatenate([src, np.zeros(padn, src.dtype)])
            tgt = np.concatenate([tgt, np.full(padn, N - 1, tgt.dtype)])
            mask = np.concatenate([mask, np.zeros(padn, bool)])
            gidx = np.concatenate([gidx, np.full(padn, B * C - 1,
                                                 gidx.dtype)])
            tabidx = np.concatenate([tabidx, np.full(padn, B * L - 1,
                                                     tabidx.dtype)])
            onehot = np.concatenate([onehot, np.zeros((padn, R),
                                                      onehot.dtype)])
            key = np.concatenate([key, np.full(padn, N, key.dtype)])
        return _pack_sorted(
            src.astype(np.int32), tgt.astype(np.int32), mask, key,
            gidx.astype(np.int32), tabidx.astype(np.int32),
            np.ascontiguousarray(onehot, np.float32),
            N=N, B=B, C=C, L=L, nb=nb, pk=PKv, pw=PWv,
            tgt_rank_cap=rank_cap_, tab_cap=tab_cap_)

    if tab_cap and not (tab_cap % 8 == 0 and tab_cap < L):
        tab_cap = 0     # a cap the pack never applies costs no attempt
    # the all-or-none fallback ladder, as the single-device batch falls
    # back per batch (tab first: the cheaper rebuild)
    attempts = [(tab_cap, tgt_rank_cap)]
    if tab_cap:
        attempts.append((0, tgt_rank_cap))
    if tgt_rank_cap:
        attempts.append((tab_cap, 0))
    if tab_cap and tgt_rank_cap:
        attempts.append((0, 0))
    for tab_c, rank_c in attempts:
        cand = [pack(p, tab_c, rank_c) for p in range(n_parts)]
        if tab_c and not all(s.tab_sel is not None for s in cand):
            continue   # a shard fell back to the uncompacted table space
        if all(_caps_of(s) == _caps_of(cand[0]) for s in cand[1:]):
            break      # the last rung, no cap, always agrees
    return PartitionedEdges(shards=tuple(cand))


def hgt_conv_core_partitioned(
    x,              # [T, C, Din] (replicated along the graph axis)
    shard: EdgeShard,
    em,
    *,
    wq, bq, wk, bk, wv, bv,
    rel_pri, rel_att, rel_msg,
    n_heads: int,
    rte_vec=None,
    overlap: bool = False,
    save_kv: bool = False,
    edge_dtype=None,
    edge_bwd: str = "permute",
    seg_pallas: bool = False,
    softmax_pallas: bool = False,
    softmax_tilemax=False,
):
    """Edge-partitioned HGT attention: the production sorted core on this
    rank's shard, with the cross-shard exchanges (softmax statistics,
    aggregation, the backward's Jacobian term and the inputs' gradients)
    over the shard's graph group. Returns the whole batch's
    aggregation ``[T, C, Dout]`` on every rank of the group. Every
    single-device knob (``save_kv``, the bf16 edge stage, the kernels, the
    backward strategy) applies per shard; ``overlap`` routes the exchanges
    through :func:`~pyhgt_tpu_torch.ops.sorted_hgt.ring_allreduce`."""
    return hgt_conv_core_sorted(
        x, shard.se, em, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv,
        rel_pri=rel_pri, rel_att=rel_att, rel_msg=rel_msg,
        n_heads=n_heads, rte_vec=rte_vec, save_kv=save_kv,
        edge_dtype=edge_dtype, edge_bwd=edge_bwd, seg_pallas=seg_pallas,
        softmax_pallas=softmax_pallas, softmax_tilemax=softmax_tilemax,
        graph_group=shard.group, gp_overlap=overlap)
