"""Scatter-free HGT edge stage over target-sorted edges.

Counterpart of :mod:`pyhgt_tpu.ops.sorted_hgt` on one device. The edge
stage is: gather the K/V rows of each edge
(relation-transformed node banks + RTE tables), score against the target's
query, softmax per target segment, and sum the weighted messages per
target. Per-segment reductions follow the JAX package's hierarchical
scheme over the host aux of :mod:`pyhgt_tpu_torch.sampling.sorted_batch`:

- level 1 sums rows per (tile, local segment rank): the wide ``[E, D]``
  aggregation through the ``live_partials`` kernels
  (:mod:`pyhgt_tpu_torch.ops.pallas_seg`) when ``seg_pallas`` is on, the
  narrow ``[E, H]`` softmax sums by an ``index_add_`` into tile-local rows
  (the TPU package's per-tile one-hot matmul computes the same sums) or,
  with ``softmax_pallas``, through the ``segment_softmax_partials`` kernel;
- level 2 adds the few live rows of each segment together.

The JAX package wraps the edge stage in a ``jax.custom_vjp``; here it is a
``torch.autograd.Function`` (:func:`hgt_edge_stage`) whose backward is the
JAX package's scatter-free ``_edge_bwd``: the gradients of the gathered K/V
banks and RTE tables are segment sums over the src and tab groupings, never
scatters. Its four strategies (``edge_bwd``) differ in how the per-edge
gradient rows reach src order: ``permute`` (two ``[E, D]`` row permutes,
``live_partials_pair``), ``slab`` (one ``[E, 2D]`` permute,
``live_partials_slab``), ``src_direct`` and ``recompute`` (rebuilt in the
sorted order from node-sized tables). The algebra matches the reference
(``pyHGT/conv.py:60-111``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from pyhgt_tpu_torch.ops.hgt import (
    _block_relation_transform,
    _rte_block_tables,
    typed_linear,
)
from pyhgt_tpu_torch.ops.pallas_seg import (
    live_partials,
    live_partials_pair,
    live_partials_slab,
    live_partials_weighted,
    segment_softmax_partials,
)
from pyhgt_tpu_torch.parallel import mesh as pmesh

NEG = -1e30
_TILE = 128  # narrow-reduction tile (the host aux's REDUCE_TILE)
EDGE_BWD = ("permute", "recompute", "src_direct", "slab")
# Routes _seg_sum_weighted through the live_partials_weighted kernel (the
# product head_expand(w) * v formed in the kernel, the [E, D] message tensor
# never written). Off, as in the JAX package; read at call time, in the
# forward and in the backward, so a caller may flip it between steps.
WEIGHTED_KERNEL = False
# exp(att - m_tile) underflows to zero below ~-87.3 (f32 min normal); the
# "auto" tilemax guard trips with headroom
TILEMAX_SPREAD = 80.0


# ---------------------------------------------------------------- primitives
def _row_segments(seg_ptr, n_rows):
    """Segment id of each of ``n_rows`` sorted rows under the CSR pointer
    ``seg_ptr [S+1]``; rows outside ``[seg_ptr[0], seg_ptr[S])`` get S."""
    S = seg_ptr.shape[0] - 1
    rows = torch.arange(n_rows, dtype=seg_ptr.dtype, device=seg_ptr.device)
    seg = torch.searchsorted(seg_ptr, rows, right=True).long() - 1
    return torch.where(seg < 0, S, seg)


def seg_sum_csr(data, seg_ptr):
    """Per-segment sums [S, ...] f32 of sorted ``data [E, ...]``; ``seg_ptr
    [S+1]`` delimits the segments (CSR).

    The JAX package takes a cumsum difference, a cheap matmul scan on the
    TPU; here each row is added straight into its segment (``index_add_``),
    since a dim-0 cumsum of a [14016, 512] f32 tensor measured ~3 ms on the
    H100 (chip_smoke.py --profile). The sum of a segment's few rows is also
    free of the cumsum difference's cancellation error.
    """
    S = seg_ptr.shape[0] - 1
    seg = _row_segments(seg_ptr, data.shape[0])
    out = torch.zeros((S + 1,) + tuple(data.shape[1:]), dtype=torch.float32,
                      device=data.device)
    return out.index_add_(0, seg, data.float())[:S]


def seg_max_csr(data, seg_ptr):
    """Per-segment max [S, ...] f32 of sorted ``data`` (empty segments:
    NEG)."""
    S = seg_ptr.shape[0] - 1
    seg = _row_segments(seg_ptr, data.shape[0])
    idx = seg.reshape((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    out = torch.full((S + 1,) + tuple(data.shape[1:]), NEG,
                     dtype=torch.float32, device=data.device)
    return out.scatter_reduce_(0, idx, data.float(), "amax")[:S]


def _shift_max(x, ids, width):
    """Segmented running max along axis 1 of ``x [tiles, width, ...]`` by
    Hillis–Steele shifts: ``ids [tiles, width]`` sorted within each row."""
    tail = (1,) * (x.dim() - 2)
    s = 1
    while s < width:
        sx = torch.cat(
            [torch.full_like(x[:, :s], NEG), x[:, :-s]], dim=1)
        sid = torch.cat(
            [torch.full_like(ids[:, :s], -1), ids[:, :-s]], dim=1)
        same = (sid == ids).reshape(ids.shape + tail)
        x = torch.where(same, torch.maximum(x, sx), x)
        s *= 2
    return x


def ring_allreduce(x, group, op: str = "sum"):
    """Ring all-reduce over the process ``group``: reduce-scatter, then
    all-gather, one 1/P-sized chunk of the rows per hop
    (:func:`~pyhgt_tpu_torch.parallel.mesh.exchange`, the ``ppermute`` of
    the JAX package's ring): the form whose hops can overlap the edge
    stage's other work. ``op`` is ``"sum"`` or ``"max"``; a row count not
    divisible by P is padded with the op's identity. Returns a new
    tensor."""
    if group is None:
        return x
    ranks = dist.get_process_group_ranks(group)
    P = len(ranks)
    if P == 1:
        return x
    idx = ranks.index(dist.get_rank())
    n0 = x.shape[0]
    pad = (-n0) % P
    fill = NEG if op == "max" else 0.0
    buf = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                   dtype=x.dtype, device=x.device)]) \
        if pad else x.clone()
    c = buf.shape[0] // P
    combine = torch.maximum if op == "max" else torch.add
    nxt, prv = ranks[(idx + 1) % P], ranks[(idx - 1) % P]
    send = buf[idx * c:(idx + 1) * c]
    for st in range(P - 1):
        got = pmesh.exchange(send, nxt, prv, group)
        j = (idx - st - 1) % P
        send = combine(buf[j * c:(j + 1) * c], got)
        buf[j * c:(j + 1) * c] = send
    g = send
    for st in range(P - 1):
        g = pmesh.exchange(g, nxt, prv, group)
        j = (idx - st) % P
        buf[j * c:(j + 1) * c] = g
    return buf[:n0]


def _xreduce(x, xr, op: str):
    """Cross-shard combine of the edge-partitioned edge stage: ``xr`` is
    ``None`` (one shard: the identity) or ``(group, overlap)``, the graph
    axis's process group and whether to go round the ring
    (:func:`ring_allreduce`) instead of one all-reduce."""
    if xr is None:
        return x
    group, overlap = xr
    if overlap:
        return ring_allreduce(x, group, op)
    return pmesh.all_reduce(x.contiguous(), group, op)


def _tile_partials(data, tile_local, K=_TILE):
    """Level 1 of the tiled segment sum: f32 ``[tiles*K + 1, ...]`` whose
    row ``t*K + r`` sums tile t's rows of local rank r; the extra last row
    is the zero row padded live rows point at."""
    E = data.shape[0]
    tiles = E // K
    tile_of = torch.arange(E, device=data.device) // K
    rows = tile_of * K + tile_local
    out = torch.zeros((tiles * K + 1,) + tuple(data.shape[1:]),
                      dtype=torch.float32, device=data.device)
    return out.index_add_(0, rows, data.float())


def seg_sum_tiled(data, tile_local, live_idx, seg_ptr2, K=_TILE):
    """Hierarchical tiled segment sum: per-(tile, local rank) partials, then
    the ≤ S+E/K live rows — already in segment order — added per segment."""
    live = _tile_partials(data, tile_local, K)[live_idx]
    return seg_sum_csr(live, seg_ptr2)


def seg_max_tiled(data, seg_ids, live_last, seg_ptr2, K=_TILE):
    """Hierarchical tiled segment max: in-tile shift steps, then a small
    second-level segmented max over the live rows."""
    E = data.shape[0]
    tiles = E // K
    x = data.float().reshape((tiles, K) + tuple(data.shape[1:]))
    run = _shift_max(x, seg_ids.reshape(tiles, K), K)
    run = run.reshape((E,) + tuple(data.shape[1:]))
    run = torch.cat([run, torch.full_like(run[:1], NEG)], dim=0)
    live = run[live_last]                     # [M, ...] per-live-row max
    return seg_max_csr(live, seg_ptr2)


def _pallas_ok(data, paux, use_pallas: bool) -> bool:
    # narrow ([E, H]) and n-D data stay on the plain tiled path, as in the
    # JAX package
    return (
        use_pallas
        and paux is not None
        and data.dim() == 2
        and data.shape[1] >= 128
    )


_GROUPING_AUX = {
    "tgt": ("tl_tgt", "live_idx_tgt", "seg_ptr2_tgt", "pseg_tgt"),
    "src": ("tl_src", "live_idx_src", "seg_ptr2_src", "pseg_src"),
    "tab": ("tl_tab", "live_idx_tab", "seg_ptr2_tab", "pseg_tab"),
}


def _seg_sum_grouped(data, se, grouping: str, use_pallas: bool):
    """Per-segment sum of ``data`` (already in ``grouping``'s edge order):
    wide 2-D tensors through the ``live_partials`` kernel when the batch
    carries its aux."""
    tl_n, li_n, sp2_n, paux_n = _GROUPING_AUX[grouping]
    paux = getattr(se, paux_n)
    if _pallas_ok(data, paux, use_pallas):
        live = live_partials(data, paux)
        return seg_sum_csr(live, paux.ptr2)
    return seg_sum_tiled(data, getattr(se, tl_n), getattr(se, li_n),
                         getattr(se, sp2_n))


def _seg_sum_grouped_pair(d1, d2, se, grouping: str, use_pallas: bool):
    """Segment sums of TWO same-shape tensors in the same grouping order:
    through :func:`~pyhgt_tpu_torch.ops.pallas_seg.live_partials_pair` (one
    pass, ``loc`` read once: the backward's g_k/g_v pairs) when eligible,
    otherwise two independent reductions.

    The SRC grouping has two narrower forms when the batch carries their
    aux. Two-region (``pseg_src_lo``): the meta blocks, a static contiguous
    slice, through the rank-capped aux; the self-block tail (one edge per
    node) by a plain CSR sum over its few rows; the banks concatenate, since
    the segment spaces are disjoint. Singleton-split (``pseg_src_multi``):
    degree-1 segments, whose "sum" is one row copy, bypass the kernel through
    a pure gather (their rows are dead rows of the aux)."""
    lo = se.pseg_src_lo if grouping == "src" else None
    if (lo is not None and _pallas_ok(d1, lo, use_pallas)
            and d1.shape == d2.shape):
        cut = se.src_cut
        l1, l2 = live_partials_pair(d1[:cut], d2[:cut], lo)
        h1 = seg_sum_csr(l1, lo.ptr2)
        h2 = seg_sum_csr(l2, lo.ptr2)
        t1 = seg_sum_csr(d1[cut:], se.src_tail_ptr2)
        t2 = seg_sum_csr(d2[cut:], se.src_tail_ptr2)
        return torch.cat([h1, t1], dim=0), torch.cat([h2, t2], dim=0)
    pm = se.pseg_src_multi if grouping == "src" else None
    if (pm is not None and _pallas_ok(d1, pm, use_pallas)
            and d1.shape == d2.shape):
        l1, l2 = live_partials_pair(d1, d2, pm)
        s1 = seg_sum_csr(l1, pm.ptr2)
        s2 = seg_sum_csr(l2, pm.ptr2)
        idx, inv = se.src_single_edges, se.src_single_inv
        z = torch.zeros((1, d1.shape[1]), dtype=s1.dtype, device=s1.device)
        g1 = torch.cat([d1[idx].to(s1.dtype), z], dim=0)
        g2 = torch.cat([d2[idx].to(s2.dtype), z], dim=0)
        return s1 + g1[inv], s2 + g2[inv]
    paux = getattr(se, _GROUPING_AUX[grouping][3])
    if _pallas_ok(d1, paux, use_pallas) and d1.shape == d2.shape:
        l1, l2 = live_partials_pair(d1, d2, paux)
        return seg_sum_csr(l1, paux.ptr2), seg_sum_csr(l2, paux.ptr2)
    return (_seg_sum_grouped(d1, se, grouping, use_pallas),
            _seg_sum_grouped(d2, se, grouping, use_pallas))


def _seg_sum_weighted(wgt, val, H, dk, se, grouping: str, use_pallas: bool,
                      out_dtype):
    """Segment sum of ``head_expand(wgt) ⊙ val`` over one grouping. With
    ``WEIGHTED_KERNEL`` on and the kernel path eligible, the product is
    formed inside
    :func:`~pyhgt_tpu_torch.ops.pallas_seg.live_partials_weighted`;
    otherwise it is formed in ``out_dtype`` and goes through the standard
    grouped reduction. The sum accumulates in f32 either way."""
    paux = getattr(se, _GROUPING_AUX[grouping][3])
    if WEIGHTED_KERNEL and _pallas_ok(val, paux, use_pallas):
        live = live_partials_weighted(wgt.float(), val, dk, paux)
        return seg_sum_csr(live, paux.ptr2)
    if out_dtype == torch.bfloat16:
        msg = _head_expand_like(wgt, H, dk, out_dtype) * val.to(out_dtype)
    else:
        msg = (_head_expand(wgt, H, dk) * val.float()).to(out_dtype)
    return _seg_sum_grouped(msg, se, grouping, use_pallas)


def _head_sum(x, H, dk):
    """Per-head lane sums: [E, D] -> [E, H] f32."""
    return x.float().reshape(x.shape[0], H, dk).sum(-1)


def _head_sum_prod(a, b, H, dk):
    """``_head_sum(a ⊙ b)`` with the product in f32 (``b`` is cast inside
    the multiply, not materialized as an f32 copy)."""
    return _head_sum(a.float() * b, H, dk)


def _head_expand(w, H, dk):
    """Per-head scalars to lanes: [E, H] -> [E, D] f32."""
    return w.float().repeat_interleave(dk, dim=1)


def _head_expand_like(w, H, dk, dt):
    """:func:`_head_expand` emitted in the edge dtype (``w`` rounds to
    ``dt`` once, as the JAX package's bf16-output 0/1 matmul does; rounding
    before the repeat writes no f32 [E, D] intermediate)."""
    return w.to(dt).repeat_interleave(dk, dim=1)


# --------------------------------------------------------------- edge stage
def _gather_kv(k_rel, v_rel, k_tab, v_tab, gidx, tabidx, use_rte):
    k_e = k_rel[gidx]
    v_e = v_rel[gidx]
    if use_rte:
        k_e = k_e + k_tab[tabidx]
        v_e = v_e + v_tab[tabidx]
    return k_e, v_e


def _attention(q_e, k_e, pri_e, mask, H, dk):
    """``(pre, att)``: the prior-less logits and the masked logits."""
    pre = _head_sum_prod(q_e, k_e, H, dk) / math.sqrt(dk)
    att = pre * pri_e.float()
    return pre, torch.where(mask[:, None], att, torch.full_like(att, NEG))


def _softmax_tiled(att, se, xr=None):
    m_n = seg_max_tiled(att, se.edge_tgt, se.live_last_tgt, se.seg_ptr2_tgt)
    m_n = _xreduce(m_n, xr, "max")   # cross-shard boundary exchange (gp)
    ex = torch.exp(att - m_n[se.edge_tgt]) * se.edge_mask[:, None]
    den_n = seg_sum_tiled(ex, se.tl_tgt, se.live_idx_tgt, se.seg_ptr2_tgt)
    den_n = _xreduce(den_n, xr, "sum")
    den_e = torch.clamp(den_n[se.edge_tgt], min=1e-30)
    return ex / den_e


def _softmax_tilemax(att, se, K=_TILE, xr=None):
    """Segment softmax stabilized by the per-128-tile max instead of the
    per-segment running max (exact online-softmax algebra).

    With ``m_t`` the max of tile t, ``den_seg = Σ_t exp(m_t - m_seg) ·
    Σ_{e ∈ t ∩ seg} exp(att_e - m_t)``: the inner sums are the level-1 tile
    partials, the combine runs on the small live-row space in log space
    (``lse = m_tile + log(partial)``). A row can underflow only if another
    segment in its tile carries a logit >~87 above its own; a segment
    whose every slice underflowed gets zeros, as in the JAX package.

    ``xr``: on an edge-partitioned run the per-segment stabilizer crosses
    the shards before the denominators form (global max, each shard's
    denominator against it, then the sum), as in the JAX package."""
    E, H = att.shape
    tiles = E // K
    a3 = att.reshape(tiles, K, H)
    m_tile = a3.amax(dim=1)                                 # [tiles, H]
    ex_t = torch.exp(a3 - m_tile[:, None, :]).reshape(E, H) \
        * se.edge_mask[:, None]
    live = _tile_partials(ex_t, se.tl_tgt, K)[se.live_idx_tgt]   # [M, H]
    tile_of = torch.clamp(se.live_idx_tgt // K, max=tiles - 1)
    m_live = torch.where(
        (se.live_idx_tgt < tiles * K)[:, None], m_tile[tile_of],
        torch.full_like(m_tile[tile_of], NEG),
    )
    lse_live = torch.where(
        live > 0,
        m_live + torch.log(torch.clamp(live, min=1e-38)),
        torch.full_like(live, NEG),
    )
    m_n = seg_max_csr(lse_live, se.seg_ptr2_tgt)              # [S, H]
    m_n = _xreduce(m_n, xr, "max")     # cross-shard stabilizer (gp)
    S = m_n.shape[0]
    key_safe = torch.clamp(se.live_key_tgt, max=S - 1)
    scale = torch.exp(torch.clamp(lse_live - m_n[key_safe], max=0.0))
    den_n = _xreduce(seg_sum_csr(scale, se.seg_ptr2_tgt), xr, "sum")
    m_e = m_n[se.edge_tgt]
    ex = torch.where(
        m_e > -5e29,
        torch.exp(torch.clamp(att - m_e, max=0.0)),
        torch.zeros_like(att),
    ) * se.edge_mask[:, None]
    den_e = torch.clamp(den_n[se.edge_tgt], min=1e-30)
    return ex / den_e


def _softmax_tilemax_auto(att, se, K=_TILE, xr=None):
    """Runtime-guarded :func:`_softmax_tilemax`: the tilemax softmax is exact
    whenever every live logit sits within ~87 of its 128-edge tile's max.
    One ``[E, H]`` reduction checks the bound (``TILEMAX_SPREAD``) per batch
    and a violation falls back to the shift-scan softmax.

    The JAX package selects with ``lax.cond``; eager PyTorch reads the flag
    on the host, which waits for the device once per layer. Computing both
    softmaxes and selecting would need no wait but would always pay the
    shift scan that the tilemax form exists to avoid.

    On an edge-partitioned run the flag is max-reduced over the graph group
    before it is read: every shard takes the same branch, or the ranks
    would wait in different collectives."""
    E, H = att.shape
    tiles = E // K
    a3 = att.reshape(tiles, K, H)
    m_tile = a3.amax(dim=1, keepdim=True)                  # [tiles, 1, H]
    live = se.edge_mask.reshape(tiles, K)[:, :, None]
    bad = (((m_tile - a3) > TILEMAX_SPREAD) & live).any()
    if xr is not None:
        bad = _xreduce(bad.reshape(1).float(), xr, "max")[0] > 0
    if bool(bad):
        return _softmax_tiled(att, se, xr)
    return _softmax_tilemax(att, se, K, xr)


def _softmax_pallas(att, se):
    """Segment softmax via the online-partials kernel
    (:func:`~pyhgt_tpu_torch.ops.pallas_seg.segment_softmax_partials`): one
    pass over ``[E, H]`` emits per-(tile, rank) (max, sumexp) live rows; the
    level-2 online merge runs on the ~S-row live space."""
    paux = se.pseg_tgt
    S = paux.ptr2.shape[0] - 1
    m_rows, s_rows = segment_softmax_partials(att, paux)
    key = paux.live_key
    # dead output rows lie past ptr2[S]: seg_max_csr gives them no segment
    m_n = seg_max_csr(m_rows, paux.ptr2)                   # [S, H]
    key_safe = torch.clamp(key, max=S - 1)
    # online merge: den = sum over live rows of exp(m_row - m_seg) * s_row
    scale = torch.exp(torch.clamp(m_rows - m_n[key_safe], max=0.0))
    den_n = seg_sum_csr(scale * s_rows, paux.ptr2)
    ex = torch.exp(att - m_n[se.edge_tgt]) * se.edge_mask[:, None]
    den_e = torch.clamp(den_n[se.edge_tgt], min=1e-30)
    return ex / den_e


def _softmax(att, se, softmax_tilemax, softmax_pallas, xr=None):
    """The edge stage's segment softmax ``w [E, H]`` f32, routed as the JAX
    package routes it: the kernel form needs the legacy target aux (its
    ``live_key``, and no rank cap: ``v == 0``), so on a capped aux
    ``softmax_pallas`` silently takes the next form; then tilemax
    (``"auto"``: guarded, any other true value: unguarded); else the
    shift-scan softmax. Edge-partitioned (``xr``), the kernel form is
    skipped as in the JAX package: its partials see one shard's edges and
    have no cross-shard combine."""
    paux = se.pseg_tgt
    if (xr is None and softmax_pallas and paux is not None
            and paux.live_key is not None and not paux.v):
        return _softmax_pallas(att, se)
    if softmax_tilemax == "auto":
        return _softmax_tilemax_auto(att, se, xr=xr)
    if softmax_tilemax:
        return _softmax_tilemax(att, se, xr=xr)
    return _softmax_tiled(att, se, xr)


def _edge_fwd_impl(q_n, k_rel, v_rel, k_tab, v_tab, pri_e, se, H, dk,
                   use_rte, seg_pallas, softmax_tilemax,
                   softmax_pallas=False, xr=None):
    dt = k_rel.dtype
    k_e, v_e = _gather_kv(k_rel, v_rel, k_tab, v_tab, se.gidx, se.tabidx,
                          use_rte)
    q_e = q_n[se.edge_tgt]
    pre, att = _attention(q_e, k_e, pri_e, se.edge_mask, H, dk)
    w = _softmax(att, se, softmax_tilemax, softmax_pallas, xr)
    aggr = _seg_sum_weighted(w, v_e, H, dk, se, "tgt", seg_pallas, dt)
    return aggr, w, pre, k_e, v_e


def _edge_bwd(g_aggr, q_n, k_rel, v_rel, k_tab, v_tab, pri_e, w, pre, kv, se,
              H, dk, use_rte, seg_pallas, edge_bwd="permute", xr=None):
    """Scatter-free backward of the edge stage, in one of the JAX package's
    four strategies for the src/tab-grouped gradient reductions:

    - ``permute``: g_k_e / g_v_e are formed once in tgt order, each [E, D]
      tensor is permute-gathered into src order, and the bank gradients are
      segment sums there. The RTE-table gradients come straight off the
      src-ordered pair through the tab-window aux when the batch has one;
      otherwise off a second permute into tab order.
    - ``slab``: the pair lane-concatenated into one [E, 2D] tensor, so the
      backward pays ONE row permute and one node-table gather, and
      :func:`~pyhgt_tpu_torch.ops.pallas_seg.live_partials_slab` sums both
      halves. Needs ``seg_pallas``, the src aux and D >= 128; else permute.
    - ``src_direct``: g_k / g_v built natively in src order (the narrow
      [E, H] coefficients permute, the wide reads are [N, D]-table gathers
      at ``tgt_src_order``); the tab grouping rides the src-ordered pair
      through the window aux, or is rebuilt the same way in tab order.
    - ``recompute``: both groupings rebuilt natively in their own order;
      no [E, D] permute at all.

    Edge-partitioned (``xr``), the softmax Jacobian's per-segment sum
    crosses the shards; every returned gradient is this shard's part.
    """
    dt = k_rel.dtype
    D = q_n.shape[-1]
    mask = se.edge_mask
    if kv is not None:
        k_e, v_e = kv                      # saved: no backward re-gathers
    else:
        k_e, v_e = _gather_kv(k_rel, v_rel, k_tab, v_tab, se.gidx, se.tabidx,
                              use_rte)

    g_aggr_l = g_aggr.to(dt)                               # [N, D] table
    g_msg = g_aggr_l[se.edge_tgt]                          # node gather
    g_w = _head_sum_prod(g_msg, v_e, H, dk)                # [E, H]

    # softmax backward: g_att = w * (g_w - sum_seg(w * g_w)); the sum
    # crosses the graph shards on a partitioned run
    s_n = _xreduce(
        seg_sum_tiled(w * g_w, se.tl_tgt, se.live_idx_tgt, se.seg_ptr2_tgt),
        xr, "sum")
    g_att = w * (g_w - s_n[se.edge_tgt])
    g_att = torch.where(mask[:, None], g_att, torch.zeros_like(g_att))

    g_pri_e = g_att * pre                                  # [E, H]
    coef = g_att * pri_e.float() / math.sqrt(dk)

    # tgt-grouped: g_q_n (k_e is already in tgt order)
    g_q_n = _seg_sum_weighted(coef, k_e, H, dk, se, "tgt", seg_pallas, dt)

    def grads_in_order(perm, tgt_order):
        """g_k (= coef ⊙ q_tgt) and g_v (= w ⊙ g_aggr_tgt) rebuilt natively
        in one grouping's edge order: narrow [E, H] permutes, head-expanded
        to lanes, times rows gathered from the node-sized tables."""
        coef_o = _head_expand(coef[perm], H, dk)
        w_o = _head_expand(w[perm], H, dk)
        q_o = q_n.to(dt)[tgt_order].float()
        gm_o = g_aggr_l[tgt_order].float()
        return (coef_o * q_o).to(dt), (w_o * gm_o).to(dt)

    g_k_tab = g_v_tab = None
    paux_src = se.pseg_src
    if edge_bwd == "recompute":
        g_k_rel, g_v_rel = _seg_sum_grouped_pair(
            *grads_in_order(se.perm_src, se.tgt_src_order), se, "src",
            seg_pallas)
        if use_rte:
            g_k_tab, g_v_tab = _seg_sum_grouped_pair(
                *grads_in_order(se.perm_tab, se.tgt_tab_order), se, "tab",
                seg_pallas)
    elif (edge_bwd == "slab" and seg_pallas and paux_src is not None
            and D >= 128):
        table = torch.cat([q_n.to(dt), g_aggr_l], dim=1)
        qgm = table[se.edge_tgt].float()                   # [E, 2D]
        # [coef | w] expanded per head: the JAX package's one block-diagonal
        # matmul (_head_mat2) is the same repeat over 2H columns
        cw_exp = _head_expand(torch.cat([coef, w], dim=1), 2 * H, dk)
        g_kv_e = (cw_exp * qgm).to(dt)                     # [E, 2D]
        g_kv_src = g_kv_e[se.perm_src]                     # 1 permute
        l1, l2 = live_partials_slab(g_kv_src, paux_src)
        g_k_rel = seg_sum_csr(l1, paux_src.ptr2)
        g_v_rel = seg_sum_csr(l2, paux_src.ptr2)
        if use_rte:
            ptab = se.ptab_src
            if ptab is not None:
                t1, t2 = live_partials_slab(g_kv_src, ptab)
            else:
                ptab = se.pseg_tab
                t1, t2 = live_partials_slab(g_kv_e[se.perm_tab], ptab)
            g_k_tab = seg_sum_csr(t1, ptab.ptr2)
            g_v_tab = seg_sum_csr(t2, ptab.ptr2)
    else:
        src_direct = edge_bwd == "src_direct"
        if src_direct:
            gk_src, gv_src = grads_in_order(se.perm_src, se.tgt_src_order)
        else:
            if dt == torch.bfloat16:
                # bf16-native products (no f32 [E, D] intermediates); q_e /
                # g_msg are bf16 rows
                q_e = q_n[se.edge_tgt]
                g_k_e = _head_expand_like(coef, H, dk, dt) * q_e
                g_v_e = _head_expand_like(w, H, dk, dt) * g_msg
            else:
                q_e = q_n[se.edge_tgt].float()
                g_k_e = (_head_expand(coef, H, dk) * q_e).to(dt)
                g_v_e = (_head_expand(w, H, dk) * g_msg.float()).to(dt)
            gk_src = g_k_e[se.perm_src]
            gv_src = g_v_e[se.perm_src]
        g_k_rel, g_v_rel = _seg_sum_grouped_pair(gk_src, gv_src, se, "src",
                                                 seg_pallas)
        if use_rte:
            ptab = se.ptab_src
            if _pallas_ok(gk_src, ptab, seg_pallas):
                # tab-window kernel: blocks are contiguous in src order, so
                # (block, Δt) fits a two-block window and the two [E, D] tab
                # permutes vanish
                l1, l2 = live_partials_pair(gk_src, gv_src, ptab)
                g_k_tab = seg_sum_csr(l1, ptab.ptr2)
                g_v_tab = seg_sum_csr(l2, ptab.ptr2)
            elif src_direct:
                # no window aux: rebuild the pair natively in tab order
                g_k_tab, g_v_tab = _seg_sum_grouped_pair(
                    *grads_in_order(se.perm_tab, se.tgt_tab_order), se,
                    "tab", seg_pallas)
            else:
                g_k_tab, g_v_tab = _seg_sum_grouped_pair(
                    g_k_e[se.perm_tab], g_v_e[se.perm_tab], se, "tab",
                    seg_pallas)
    if use_rte:
        g_k_tab = g_k_tab.to(k_tab.dtype)
        g_v_tab = g_v_tab.to(v_tab.dtype)
    return (g_q_n.to(q_n.dtype), g_k_rel.to(k_rel.dtype),
            g_v_rel.to(v_rel.dtype), g_k_tab, g_v_tab,
            g_pri_e.to(pri_e.dtype))


class _EdgeStage(torch.autograd.Function):
    """The edge stage with its hand-written backward (the JAX package's
    ``jax.custom_vjp`` pair ``_edge_fwd`` / ``_edge_bwd``). ``se`` and the
    static dims are not tensors: they ride on ``ctx``."""

    @staticmethod
    def forward(ctx, q_n, k_rel, v_rel, k_tab, v_tab, pri_e, se, dims):
        (H, dk, use_rte, save_kv, seg_pallas, softmax_tilemax,
         softmax_pallas, _, xr) = dims
        aggr, w, pre, k_e, v_e = _edge_fwd_impl(
            q_n, k_rel, v_rel, k_tab, v_tab, pri_e, se, H, dk, use_rte,
            seg_pallas, softmax_tilemax, softmax_pallas, xr)
        if any(ctx.needs_input_grad):
            # `pre` ([E, H], the prior-less logits) rides along so the
            # backward never re-gathers q_e for it
            kv = (k_e, v_e) if save_kv else ()
            ctx.save_for_backward(q_n, k_rel, v_rel, k_tab, v_tab, pri_e, w,
                                  pre, *kv)
            ctx.se, ctx.dims = se, dims
        return aggr

    @staticmethod
    def backward(ctx, g_aggr):
        H, dk, use_rte, _, seg_pallas, _, _, edge_bwd, xr = ctx.dims
        q_n, k_rel, v_rel, k_tab, v_tab, pri_e, w, pre, *kv = ctx.saved_tensors
        if ctx.se.perm_src is None:
            raise ValueError("the backward needs a batch sorted with "
                             "with_backward=True")
        grads = _edge_bwd(g_aggr, q_n, k_rel, v_rel, k_tab, v_tab, pri_e, w,
                          pre, tuple(kv) or None, ctx.se, H, dk, use_rte,
                          seg_pallas, edge_bwd, xr)
        return (*grads, None, None)


def hgt_edge_stage(q_n, k_rel, v_rel, k_tab, v_tab, pri_e, se, *, H, dk,
                   use_rte, save_kv=False, seg_pallas=False,
                   softmax_tilemax=False, softmax_pallas=False,
                   edge_bwd="permute", xr=None):
    """The edge stage: returns ``aggr [N, D]`` (f32). Inputs as in the JAX
    package's ``hgt_edge_stage``: ``q_n [N, D]`` target queries,
    ``k_rel/v_rel [B*C, D]`` relation-transformed banks, ``k_tab/v_tab``
    RTE tables (``None`` without RTE), ``pri_e [E, H]``. Differentiable in
    the six tensors through :func:`_edge_bwd` in the strategy ``edge_bwd``;
    ``save_kv`` keeps the gathered ``k_e``/``v_e`` for it (2 E×D buffers for
    2 fewer backward gathers). ``softmax_tilemax`` (False | True | "auto")
    and ``softmax_pallas`` choose the softmax form (:func:`_softmax`). Under
    ``torch.no_grad()`` nothing is kept. ``xr = (group, overlap)``: ``se``
    is one shard of an edge-partitioned batch, and ``aggr`` and the input
    gradients are this shard's parts (:func:`hgt_conv_core_sorted` combines
    them)."""
    if edge_bwd not in EDGE_BWD:
        raise ValueError(f"edge_bwd {edge_bwd!r} not in {EDGE_BWD}")
    dims = (H, dk, use_rte, save_kv, seg_pallas, softmax_tilemax,
            softmax_pallas, edge_bwd, xr)
    return _EdgeStage.apply(q_n, k_rel, v_rel, k_tab, v_tab, pri_e, se, dims)


def hgt_edge_attention(q_n, k_rel, v_rel, k_tab, v_tab, pri_e, se, *, H, dk,
                       use_rte, seg_pallas=False, softmax_tilemax=False,
                       softmax_pallas=False, xr=None):
    """The ``[E, H]`` softmax attention weights of the edge stage, in the
    sorted edge order (the reference stashes them on the module for
    visualization, ``pyHGT/conv.py:106-108``). Not differentiated."""
    with torch.no_grad():
        return _edge_fwd_impl(q_n, k_rel, v_rel, k_tab, v_tab, pri_e, se, H,
                              dk, use_rte, seg_pallas, softmax_tilemax,
                              softmax_pallas, xr)[1]


class _SumGradsOverShards(torch.autograd.Function):
    """Identity forward; the backward sums each input's gradient over the
    graph group (one flat f32 all-reduce). Applied to the inputs of an
    edge-partitioned conv core: the core's work is replicated on every
    rank but the edge stage's, which sees one shard, so each rank's
    backward gives these inputs its shard's part of their gradients, and
    the sum is the single-device gradient, the same on every rank (the JAX
    package gets this from ``shard_map``'s transpose of its replicated
    inputs). The inputs (the layer's input and weights, ~44 MB f32 a layer
    at the bench preset) are the smallest cut: the node-level tensors
    entering the edge stage are ~200 MB."""

    @staticmethod
    def forward(ctx, xr, *xs):
        ctx.xr = xr
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([
            (g if g is not None else torch.zeros(shape, device=dev)
             ).reshape(-1).float()
            for g, (shape, _, dev) in zip(gs, ctx.meta)])
        flat = _xreduce(flat, ctx.xr, "sum")
        out, at = [], 0
        for shape, dt, _ in ctx.meta:
            n = math.prod(shape)
            out.append(flat[at:at + n].reshape(shape).to(dt))
            at += n
        return (None, *out)


class _SumOverShards(torch.autograd.Function):
    """Forward: the sum of each shard's partial aggregation over the graph
    group; backward: the identity (each shard's partial enters the sum
    once, so its gradient is the sum's, which every rank holds)."""

    @staticmethod
    def forward(ctx, x, xr):
        return _xreduce(x.clone(), xr, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_grads_over(group, *xs):
    """``xs`` unchanged, their gradients summed over the process ``group``
    in the backward (one flat f32 all-reduce): Megatron's "f" at the
    entry of tensor parallelism's column-parallel projections, where each
    model rank's backward holds only its heads' part of the input's
    gradient (:class:`_SumGradsOverShards`, gp's rule for the same
    reason)."""
    return _SumGradsOverShards.apply((group, False), *xs)


def sum_over(x, group):
    """``x`` summed over the process ``group``, the backward the identity:
    Megatron's "g" after a row-parallel product's partial sums
    (:class:`_SumOverShards`)."""
    return _SumOverShards.apply(x, (group, False))


def _tab_select(k_tab, v_tab, tab_sel):
    """Compact-table rows: a row gather. The JAX package selects with a
    one-hot matmul because the gather's autodiff transpose compiled badly on
    XLA:TPU; the forward values are the same, and so is the gradient: the
    gather's transpose is an ``index_add`` that sums repeated indices (dead
    compact slots repeat their block's last row), as the one-hot matmul's
    transpose does."""
    return k_tab[tab_sel], v_tab[tab_sel]


# ------------------------------------------------------------- full conv core
def hgt_conv_core_sorted(
    x,                 # [T, C, Din]
    se,                # SortedEdges on x's device
    em,                # EdgeStaticMeta on x's device
    *,
    wq, bq, wk, bk, wv, bv,
    rel_pri, rel_att, rel_msg,
    n_heads: int,
    rte_vec=None,      # [L, Din] or None
    save_kv: bool = False,
    edge_dtype=None,   # e.g. torch.bfloat16: run the per-edge stage in bf16
    seg_pallas: bool = False,
    softmax_tilemax=False,
    softmax_pallas: bool = False,
    edge_bwd: str = "permute",
    return_attention: bool = False,
    graph_group=None,  # se is one shard of an edge-partitioned batch
    gp_overlap: bool = False,  # ring all-reduce boundary exchange
):
    """Attention + message aggregation over the target-sorted layout.
    Returns aggr ``[T, C, Dout]`` in ``x.dtype``. Everything around the edge
    stage is plain tensor code that autograd differentiates; the edge stage
    brings its own backward (:func:`hgt_edge_stage`) in the strategy
    ``edge_bwd`` (permute | recompute | src_direct | slab). ``save_kv``
    trades 2 E×D saved buffers for 2 fewer backward gathers.

    ``edge_dtype=torch.bfloat16`` casts the gathered tables and every
    per-edge ``[E, D]`` tensor to bf16 while logits, softmax and all segment
    accumulations stay f32. ``softmax_tilemax`` selects the per-tile-max
    softmax: any true value the unguarded form, ``"auto"`` the form that
    checks the logit spread per batch and falls back to the shift-scan
    softmax. ``softmax_pallas`` routes the softmax through the
    online-partials kernel where the target aux allows it
    (:func:`_softmax`). ``return_attention`` also returns the ``[E, H]``
    softmax weights the edge stage used, in sorted edge order.

    ``graph_group`` (a process group): ``se`` is this rank's shard of an
    edge-partitioned batch (:mod:`pyhgt_tpu_torch.parallel.edge_partition`)
    and the other ranks of the group hold the others. The node-level work
    is replicated; the softmax statistics, the backward's softmax-Jacobian
    sum and the aggregation cross the shards (all-reduces over ``[N, H]``
    and ``[N, D]``, or rings under ``gp_overlap``), so ``out`` is the whole
    batch's on every rank. In the backward each rank sums the gradients of
    the core's inputs (``x`` and the weights) over the group, so every
    parameter ends with the single-device gradient on every rank
    (:class:`_SumGradsOverShards`)."""
    xr = None
    if graph_group is not None:
        xr = (graph_group, gp_overlap)
        ins = [x, wq, bq, wk, bk, wv, bv, rel_pri, rel_att, rel_msg]
        if rte_vec is not None:
            ins.append(rte_vec)
        ins = _SumGradsOverShards.apply(xr, *ins)
        x, wq, bq, wk, bk, wv, bv, rel_pri, rel_att, rel_msg = ins[:10]
        if rte_vec is not None:
            rte_vec = ins[10]
    T, C, Din = x.shape
    Dout = wq.shape[-1]
    H, dk = n_heads, Dout // n_heads
    N = T * C

    q = typed_linear(x, wq, bq).reshape(T, C, H, dk)
    k = typed_linear(x, wk, bk).reshape(T, C, H, dk)
    v = typed_linear(x, wv, bv).reshape(T, C, H, dk)
    k_rel = _block_relation_transform(k, rel_att, em)
    v_rel = _block_relation_transform(v, rel_msg, em)
    B = k_rel.shape[0]
    k_rel = k_rel.reshape(B * C, Dout)
    v_rel = v_rel.reshape(B * C, Dout)

    use_rte = rte_vec is not None
    if use_rte:
        L = rte_vec.shape[0]
        k_tab = _rte_block_tables(rte_vec, wk, rel_att, em, H, dk).reshape(B * L, Dout)
        v_tab = _rte_block_tables(rte_vec, wv, rel_msg, em, H, dk).reshape(B * L, Dout)
    else:
        k_tab = v_tab = None
    if use_rte and se.tab_sel is not None:
        k_tab, v_tab = _tab_select(k_tab, v_tab, se.tab_sel)
    pri_e = se.rel_onehot @ rel_pri.float()              # [E, H]

    q_n = q.reshape(N, Dout)

    if edge_dtype is not None:
        q_n = q_n.to(edge_dtype)
        k_rel = k_rel.to(edge_dtype)
        v_rel = v_rel.to(edge_dtype)
        if use_rte:
            k_tab = k_tab.to(edge_dtype)
            v_tab = v_tab.to(edge_dtype)

    tilemax = "auto" if softmax_tilemax == "auto" else bool(softmax_tilemax)
    aggr = hgt_edge_stage(
        q_n, k_rel, v_rel, k_tab, v_tab, pri_e, se, H=H, dk=dk,
        use_rte=use_rte, save_kv=save_kv, seg_pallas=seg_pallas,
        softmax_tilemax=tilemax, softmax_pallas=softmax_pallas,
        edge_bwd=edge_bwd, xr=xr,
    )
    if xr is not None:
        # the shards' partial aggregations combine once per layer
        aggr = _SumOverShards.apply(aggr.float(), xr)
    out = aggr.reshape(T, C, Dout).to(x.dtype)
    if return_attention:
        w = hgt_edge_attention(
            q_n, k_rel, v_rel, k_tab, v_tab, pri_e, se, H=H, dk=dk,
            use_rte=use_rte, seg_pallas=seg_pallas, softmax_tilemax=tilemax,
            softmax_pallas=softmax_pallas, xr=xr)
        return out, w
    return out
