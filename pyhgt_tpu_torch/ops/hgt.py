"""HGT layer prologue — node-level projections and per-block tables.

Counterpart of :mod:`pyhgt_tpu.ops.hgt` (the parts the sorted forward
reads). Reference algorithm (``pyHGT/conv.py:60-134``), per edge (i =
target, j = source) of meta-relation (tt, st, r):

    x_j'  = x_j + RTE(dt)
    q     = Q_lin[tt](x_i)
    k     = K_lin[st](x_j') @ relation_att[r]
    att   = <q, k> * relation_pri[r] / sqrt(dk)
    m     = V_lin[st](x_j') @ relation_msg[r]
    aggr_i = sum_j softmax_by_target(att) * m

Two algebraic facts move the projections off the edges:

1. ``K_lin(x_j + rte) = K_lin(x_j) + W_k·rte(dt)``: the K/V projections run
   once per node (one batched ``[T,C,Din]×[T,Din,Dout]`` matmul), and the
   RTE term becomes a per-(block, dt) table of ``RTE_MAX_LEN`` rows.
2. The batch layout fixes one edge block per meta-relation, so the relation
   bases apply per block at node granularity (``[B,C,H,dk]×[B,H,dk,dk]``)
   instead of per edge.

What remains per edge is gather -> multiply-reduce -> segment softmax ->
segment sum: :func:`hgt_conv_core` runs it over the flat edge arrays with
the segment primitives of :mod:`pyhgt_tpu_torch.ops.segment` (the
reference "segment" edge path); the scatter-free sorted path is
:mod:`pyhgt_tpu_torch.ops.sorted_hgt`.
"""

from __future__ import annotations

import dataclasses

import math

import numpy as np
import torch

from pyhgt_tpu_torch.ops.segment import segment_softmax, segment_sum


@dataclasses.dataclass(frozen=True)
class EdgeStaticMeta:
    """Per-edge/per-block metadata derived from a BatchLayout.

    Built as numpy arrays (the host sort reads them); :meth:`to` gives the
    copy whose arrays are tensors on a device (the model reads those).
      block_rel   [B]  relation id of each edge block
      block_src   [B]  source node-type id of each block
      block_tgt   [B]  target node-type id of each block
      edge_block  [E]  block id of each flat edge slot
      edge_rel    [E]  relation id of each flat edge slot
      gather_off  [E]  block_id*C - src_type_id*C : turns a flat node index
                       (edge_src) into an index into the [B*C, ...] stacked
                       per-block node transforms
    """

    num_types: int
    node_cap: int
    block_rel: np.ndarray
    block_src: np.ndarray
    block_tgt: np.ndarray
    edge_block: np.ndarray
    edge_rel: np.ndarray
    gather_off: np.ndarray

    @classmethod
    def from_layout(cls, layout) -> "EdgeStaticMeta":
        blocks = layout.blocks
        C = layout.node_cap
        block_rel = np.array([b.rel_id for b in blocks], dtype=np.int32)
        block_src = np.array([b.src_type_id for b in blocks], dtype=np.int32)
        block_tgt = np.array([b.tgt_type_id for b in blocks], dtype=np.int32)
        E = layout.num_edges
        edge_block = np.zeros(E, dtype=np.int32)
        for bi, b in enumerate(blocks):
            edge_block[b.start : b.stop] = bi
        edge_rel = block_rel[edge_block]
        gather_off = (edge_block * C - block_src[edge_block] * C).astype(np.int32)
        return cls(
            num_types=layout.num_types,
            node_cap=C,
            block_rel=block_rel,
            block_src=block_src,
            block_tgt=block_tgt,
            edge_block=edge_block,
            edge_rel=edge_rel,
            gather_off=gather_off,
        )

    def to(self, device) -> "EdgeStaticMeta":
        """The same metadata with every array as an int64 tensor on
        ``device`` (index tensors for the model's gathers)."""
        arrays = {
            f.name: torch.as_tensor(np.asarray(getattr(self, f.name)),
                                    dtype=torch.int64, device=device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)
        }
        return dataclasses.replace(self, **arrays)


def typed_linear(x, w, b=None):
    """Per-type affine map: x [T,C,Din] @ w [T,Din,Dout] (+ b [T,Dout]),
    accumulated in f32 and cast back to ``x.dtype`` — one batched matmul in
    place of the reference's ``num_types`` separate Linears
    (``pyHGT/conv.py:28-40``)."""
    y = torch.bmm(x.float(), w.float())
    if b is not None:
        y = y + b.float()[:, None, :]
    return y.to(x.dtype)


def _block_relation_transform(nodes_proj, wk_rel, em: EdgeStaticMeta):
    """Apply per-relation basis matrices at node granularity per edge block.

    nodes_proj [T, C, H, dk] -> gathered per block by source type ->
    einsum with wk_rel[block_rel] [B, H, dk, dk] -> [B, C, H, dk].
    """
    by_block = nodes_proj[em.block_src]                  # [B, C, H, dk]
    # the bank in f32 before the gather, so that its gradient sums the
    # blocks in f32 (a bf16 bank under param_bf16 rounds once, at its cast)
    mats = wk_rel.float()[em.block_rel]                  # [B, H, dk, dk]
    out = torch.einsum("bchk,bhkl->bchl", by_block.float(), mats)
    return out.to(nodes_proj.dtype)


def _rte_block_tables(rte_vec, w_proj, wk_rel, em: EdgeStaticMeta, H, dk):
    """Per-(block, dt) additive K/V correction tables [B, L, H, dk].

    rte_vec [L, Din] (already through the trainable RTE linear) projected by
    the *source-type* K/V weight (no bias: the node projection carries it)
    then the block's relation basis. L = RTE_MAX_LEN = 240.
    """
    per_type = torch.einsum("ld,tde->tle", rte_vec.float(), w_proj.float())
    L = rte_vec.shape[0]
    per_type = per_type.reshape(per_type.shape[0], L, H, dk)
    by_block = per_type[em.block_src]                    # [B, L, H, dk]
    mats = wk_rel.float()[em.block_rel]                  # [B, H, dk, dk]
    out = torch.einsum("blhk,bhkm->blhm", by_block, mats)
    return out.to(rte_vec.dtype)


def hgt_conv_core(x, edge_src, edge_tgt, edge_dt, edge_mask,
                  em: EdgeStaticMeta, *, wq, bq, wk, bk, wv, bv, rel_pri,
                  rel_att, rel_msg, n_heads: int, rte_vec=None):
    """Attention and message aggregation over the flat edge arrays (the
    reference's ``message`` + scatter, ``pyHGT/conv.py:60-111``): ``x``
    ``[T, C, Din]``, ``edge_src`` / ``edge_tgt`` ``[E]`` flat node indices
    (``type * C + local``), ``edge_dt`` ``[E]`` in ``[0, RTE_MAX_LEN)``,
    ``edge_mask`` ``[E]`` bool, ``em`` on x's device; ``rte_vec`` ``[L,
    Din]`` (the sin table through the RTE linear) or None.

    Returns ``(aggr [T, C, Dout] in x's dtype, w [E, H] f32)``: the scores
    and the softmax are f32, scaled by ``rel_pri[edge_rel] / sqrt(dk)``.
    The update half (gelu, the A linear, skip gate, norm) is the conv
    module's."""
    T, C, _ = x.shape
    Dout = wq.shape[-1]
    H, dk = n_heads, Dout // n_heads
    N = T * C
    E = edge_src.shape[0]

    # node-level projections, then the relation bases per block
    q = typed_linear(x, wq, bq).reshape(T, C, H, dk)
    k = typed_linear(x, wk, bk).reshape(T, C, H, dk)
    v = typed_linear(x, wv, bv).reshape(T, C, H, dk)
    k_rel = _block_relation_transform(k, rel_att, em)   # [B, C, H, dk]
    v_rel = _block_relation_transform(v, rel_msg, em)
    B = k_rel.shape[0]
    k_rel = k_rel.reshape(B * C, Dout)
    v_rel = v_rel.reshape(B * C, Dout)

    # per-edge gathers (index_select: its backward is an index_add_,
    # :mod:`pyhgt_tpu_torch.ops.segment` says why)
    src, tgt = edge_src.long(), edge_tgt.long()
    # into [B*C, ...]; a masked edge's offset may go below 0 and wraps, as
    # an indexing gather would (its row is masked out either way)
    gidx = torch.remainder(src + em.gather_off, B * C)
    k_e = k_rel.index_select(0, gidx)
    v_e = v_rel.index_select(0, gidx)
    q_e = q.reshape(N, Dout).index_select(0, tgt)

    # the RTE's additive correction through the 240-row tables
    if rte_vec is not None:
        k_tab = _rte_block_tables(rte_vec, wk, rel_att, em, H, dk)
        v_tab = _rte_block_tables(rte_vec, wv, rel_msg, em, H, dk)
        L = rte_vec.shape[0]
        tab_idx = em.edge_block * L + edge_dt.long()
        k_e = k_e + k_tab.reshape(B * L, Dout).index_select(0, tab_idx)
        v_e = v_e + v_tab.reshape(B * L, Dout).index_select(0, tab_idx)

    # scores in f32, softmax over each target's incoming edges
    pri = rel_pri.index_select(0, em.edge_rel)           # [E, H]
    att = (q_e.float() * k_e.float()).reshape(E, H, dk).sum(dim=-1)
    att = att * pri.float() / math.sqrt(dk)
    w = segment_softmax(att, tgt, N, mask=edge_mask)     # [E, H]

    msg = (w[:, :, None] * v_e.float().reshape(E, H, dk)).reshape(E, Dout)
    aggr = segment_sum(msg, tgt, N, mask=edge_mask)      # [N, Dout]
    return aggr.reshape(T, C, Dout).to(x.dtype), w
