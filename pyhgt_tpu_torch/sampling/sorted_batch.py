"""Target-sorted edge view — the host layout of the scatter-free edge stage.

Counterpart of the numpy path of :mod:`pyhgt_tpu.sampling.sorted_batch`
(its ``sort_edges(native=False)``); every field here is bit-identical to
the JAX package's. At batch-build time the host precomputes:

- edges permuted so ``edge_tgt`` is globally non-decreasing (padding last);
- ``gidx`` (index into the per-block relation-transformed node banks) and
  ``tabidx`` (index into the per-(block, Δt) RTE tables), both permuted;
- ``rel_onehot [E, R]``: relation membership as f32 (padded rows zero);
- the tiled-reduction aux of the target grouping (``tl / live_* /
  seg_ptr2``) that the narrow ``[E, H]`` softmax sums read;
- the :class:`~pyhgt_tpu_torch.ops.pallas_seg.PallasSegAux` of the target
  grouping that the wide aggregation kernel reads;
- optionally (``tab_cap``) the per-block occupied-Δt compaction of the RTE
  table space (``tab_sel``);
- for the backward (``with_backward``): a second permutation ``perm_src``
  sorting edges by ``gidx`` and a third, ``perm_tab``, by ``tabidx``, each
  with its tiled aux and kernel aux, so the K/V gather transposes become
  sorted segment sums; and ``ptab_src``, the window aux that reduces the
  tab grouping straight off src-ordered rows;
- optionally two narrower forms of the src grouping's kernel aux: the
  singleton-split aux (``src_rank_cap``: degree-1 sources bypass the kernel)
  and the two-region aux (``src_split_cap``: the meta blocks through a
  rank-capped aux, the self-block tail through a plain CSR).

The C++ batch-prep path is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pyhgt_tpu_torch.graph.schema import SELF_REL
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.ops.pallas_seg import PK, PW, PallasSegAux
from pyhgt_tpu_torch.ops.rte import RTE_MAX_LEN
from pyhgt_tpu_torch.sampling.batch import BatchLayout, SubgraphBatch

REDUCE_TILE = 128


@dataclasses.dataclass
class SortedEdges:
    """Host arrays of the sorted edge stage (all [E] unless noted);
    :meth:`to` moves them to a device as tensors.

    ``tl_tgt`` is each edge's local segment rank within its 128-edge tile,
    ``live_idx_tgt`` lists the ≤ S+E/128 live (tile, rank) partial rows in
    segment order, ``live_last_tgt`` the flat index of each live row's last
    edge, ``live_key_tgt`` its segment id, and ``seg_ptr2_tgt`` the
    second-level CSR over live rows.
    """

    edge_src: np.ndarray      # flat source node index, tgt-sorted order
    edge_tgt: np.ndarray      # flat target node (masked edges: N - 1)
    edge_mask: np.ndarray     # bool
    gidx: np.ndarray          # into [B*C] relation-transformed node banks
    tabidx: np.ndarray        # into [B*L] (or compact [B*cap]) RTE tables
    rel_onehot: np.ndarray    # [E, R] f32
    tl_tgt: np.ndarray        # [E]
    live_idx_tgt: np.ndarray  # [Mt]
    live_key_tgt: np.ndarray  # [Mt]
    live_last_tgt: np.ndarray  # [Mt]
    seg_ptr2_tgt: np.ndarray  # [N+1]
    pseg_tgt: PallasSegAux
    # tab compaction: [B*cap] original table row per compact row; None =
    # uncompacted
    tab_sel: Optional[np.ndarray] = None
    # ---- the backward's aux; all None when built with_backward=False ----
    perm_src: Optional[np.ndarray] = None      # [E] tgt-order -> gidx-sorted
    seg_ptr_src: Optional[np.ndarray] = None   # [B*C+1]
    perm_tab: Optional[np.ndarray] = None      # [E] tgt-order -> tabidx-sorted
    seg_ptr_tab: Optional[np.ndarray] = None   # [B*Lt+1]
    tgt_src_order: Optional[np.ndarray] = None  # [E] = edge_tgt[perm_src]
    tgt_tab_order: Optional[np.ndarray] = None  # [E] = edge_tgt[perm_tab]
    # tiled-reduction aux (gidx grouping, perm_src order)
    tl_src: Optional[np.ndarray] = None        # [E]
    live_idx_src: Optional[np.ndarray] = None  # [Ms]
    seg_ptr2_src: Optional[np.ndarray] = None  # [G+1]
    # tiled-reduction aux (tabidx grouping, perm_tab order)
    tl_tab: Optional[np.ndarray] = None        # [E]
    live_idx_tab: Optional[np.ndarray] = None  # [Mtab]
    seg_ptr2_tab: Optional[np.ndarray] = None  # [Gt+1]
    pseg_src: Optional[PallasSegAux] = None
    pseg_tab: Optional[PallasSegAux] = None
    # tab-window aux: reduces the tab grouping on SRC-ordered data (no
    # [E, D] tab permutes in the backward); None when a tile spans more than
    # two meta blocks (tiny layouts) — callers fall back to pseg_tab
    ptab_src: Optional[PallasSegAux] = None
    # singleton-split src aux (src_rank_cap): multi-edge segments through a
    # rank-capped kernel aux whose dead rows (loc = -1) are the degree-1
    # segments' edges, which a pure gather adds back; see
    # pallas_seg_aux_split. None when the caps don't hold.
    pseg_src_multi: Optional[PallasSegAux] = None
    src_single_edges: Optional[np.ndarray] = None   # [cap] src-order idx
    src_single_inv: Optional[np.ndarray] = None     # [G] -> row in G/zero
    # two-region src reduction (src_split_cap): the src-sorted edge array
    # splits at the STATIC meta/self block boundary (self blocks sort last
    # and hold one edge per node). Region 1 (meta blocks) runs the
    # rank-capped kernel aux; region 2 (the self tail) needs no kernel: a
    # plain CSR over its rows. None / 0 when the boundary or the cap does
    # not hold.
    pseg_src_lo: Optional[PallasSegAux] = None      # region-1 capped aux
    src_tail_ptr2: Optional[np.ndarray] = None      # [G - S1 + 1]
    src_cut: int = 0                                # edges in region 1
    src_s1: int = 0                                 # segments in region 1

    def to(self, device) -> "SortedEdges":
        """Tensors on ``device``: indices int32 (as built: half the bytes of
        int64 to copy), the mask bool, the one-hot f32, each kernel aux as
        :meth:`PallasSegAux.to` gives it. Fields that are ``None`` stay
        ``None``; a view already made of tensors moves with ``Tensor.to``."""
        def move(a):
            if a is None or isinstance(a, int):
                return a
            if isinstance(a, PallasSegAux):
                return a.to(device)
            if isinstance(a, torch.Tensor):
                return a.to(device)
            if a.dtype == np.bool_ or a.dtype == np.float32:
                return torch.as_tensor(a, device=device)
            return torch.as_tensor(np.asarray(a, np.int32), device=device)
        return SortedEdges(**{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def pallas_seg_aux(key_sorted: np.ndarray, num_segments: int,
                   K: int = PK, W: int = PW,
                   v: int = 0) -> Optional[PallasSegAux]:
    """Host aux for :func:`~pyhgt_tpu_torch.ops.pallas_seg.live_partials`
    over one grouping.

    ``key_sorted [E]`` non-decreasing (sentinel ``num_segments`` for padded
    edges, which therefore land in trailing live rows that ``ptr2`` never
    selects). All output shapes are static functions of (E, num_segments,
    K, W). Tile t's distinct segments get consecutive ranks, and row
    ``live_off[t] + rank`` (= ``blk[t]*W + loc``) is that pair's own row.

    ``v`` is the rank cap: the most live rows a tile may add, so ``loc``
    lies in ``[0, W + v)``. Returns ``None`` when a batch violates the cap
    (the caller falls back to the legacy ``W = K`` aux).
    """
    E = key_sorted.shape[0]
    if E % K:
        raise ValueError(f"edge count {E} not a multiple of the {K} tile")
    if W < (v or K):
        raise ValueError(f"W = {W} < V = {v or K}")
    tiles = E // K
    k2 = key_sorted.reshape(tiles, K)
    new = np.ones((tiles, K), dtype=bool)
    new[:, 1:] = k2[:, 1:] != k2[:, :-1]
    rank = (np.cumsum(new, axis=1) - 1).astype(np.int64)
    n_live = rank[:, -1] + 1
    if v and int(n_live.max()) > v:
        return None
    live_off = np.concatenate([[0], np.cumsum(n_live)])       # [tiles+1]
    loc = ((live_off[:-1] % W)[:, None] + rank).astype(np.int32)
    blk = (live_off[:-1] // W).astype(np.int32)               # [tiles]
    # static block-count bound: live rows <= num_segments + tiles, plus one
    NB = (num_segments + tiles + W - 1) // W + 1
    tail = np.minimum(blk[-1] + 1 + np.arange(NB - 1), NB - 1)
    blk_ext = np.concatenate([blk, tail]).astype(np.int32)
    pos = np.flatnonzero(new.reshape(E))      # first edge of each live row
    live_key = key_sorted[pos]
    ptr2 = np.searchsorted(live_key, np.arange(num_segments + 1)).astype(
        np.int32
    )
    live_key_ext = np.full(NB * W, num_segments, dtype=np.int32)
    live_key_ext[: len(pos)] = live_key
    return PallasSegAux(loc=loc, blk=blk_ext, ptr2=ptr2,
                        live_key=live_key_ext, w=W, v=v)


def pallas_seg_aux_split(key_sorted: np.ndarray, num_segments: int,
                         K: int = PK, W: int = PW, v: int = 0,
                         single_cap: int = 0):
    """Singleton-split aux: degree-1 segments bypass the kernel.

    In the SRC grouping, runs of degree-1 sources make per-tile distinct
    counts reach K (no rank cap possible on the full space), but a singleton
    segment's "sum" is just its one edge row. This constructor numbers ranks
    over MULTI-edge segments only (singleton edges, and rows before a
    tile's first multi segment, get the dead ``loc = -1``; the aux is marked
    ``dead_rows`` and the kernels skip them) and returns the singleton
    routing for a pure-gather combine:

        bank = seg_sum_csr(kernel_partials, ptr2) + G_ext[single_inv]
        where G = data_in_grouping_order[single_edges]  (+ a zero row)

    Returns ``(aux, single_edges [single_cap], single_inv [S])`` or ``None``
    when the multi-rank cap ``v`` or ``single_cap`` is violated (the caller
    falls back to the legacy aux).
    """
    E = key_sorted.shape[0]
    if E % K:
        raise ValueError(f"edge count {E} not a multiple of the {K} tile")
    if not (v and single_cap):
        raise ValueError("split aux needs both caps")
    if W < v:
        raise ValueError(f"W = {W} < V = {v}")
    tiles = E // K
    key = np.asarray(key_sorted)
    new = np.ones(E, dtype=bool)
    new[1:] = key[1:] != key[:-1]
    seg_start = np.flatnonzero(new)
    seg_len = np.diff(np.append(seg_start, E))
    is_single_seg = seg_len == 1
    seg_of_edge = np.cumsum(new) - 1
    single_edge = is_single_seg[seg_of_edge]          # [E] bool
    n_single = int(is_single_seg.sum())
    if n_single > single_cap:
        return None

    # multi-only ranks per tile
    new2 = new.reshape(tiles, K).copy()
    new2[:, 0] = True  # a segment continuing across a tile gets a new rank
    multi_new = new2 & ~single_edge.reshape(tiles, K)
    rank = np.cumsum(multi_new, axis=1) - 1           # [tiles, K]
    n_live = multi_new.sum(axis=1)
    if int(n_live.max()) > v:
        return None
    live_off = np.concatenate([[0], np.cumsum(n_live)])
    loc = ((live_off[:-1] % W)[:, None] + rank).astype(np.int32)
    # rows before the tile's first multi segment have rank -1
    loc[~multi_new & ~np.cumsum(multi_new, axis=1).astype(bool)] = -1
    loc[single_edge.reshape(tiles, K)] = -1           # dead rows
    blk = (live_off[:-1] // W).astype(np.int32)
    NB = (num_segments + tiles + W - 1) // W + 1
    tail = np.minimum(blk[-1] + 1 + np.arange(NB - 1), NB - 1)
    blk_ext = np.concatenate([blk, tail]).astype(np.int32)

    pos = np.flatnonzero(multi_new.reshape(E))        # first edge per live row
    live_key = key[pos]
    ptr2 = np.searchsorted(live_key, np.arange(num_segments + 1)).astype(
        np.int32
    )
    live_key_ext = np.full(NB * W, num_segments, dtype=np.int32)
    live_key_ext[: len(pos)] = live_key
    aux = PallasSegAux(loc=loc, blk=blk_ext, ptr2=ptr2,
                       live_key=live_key_ext, w=W, v=v, dead_rows=True)

    single_edges = np.zeros(single_cap, np.int32)
    se_idx = seg_start[is_single_seg]                 # the segment's one edge
    single_edges[:n_single] = se_idx
    single_inv = np.full(num_segments, single_cap, np.int32)  # -> zero row
    single_rows = key[se_idx]
    positions = np.arange(n_single)
    keep = single_rows < num_segments                 # drop padding sentinel
    single_inv[single_rows[keep]] = positions[keep].astype(np.int32)
    return aux, single_edges, single_inv


def _src_split_aux(key_src_sorted: np.ndarray, cut: int, s1: int,
                   seg_ptr_src: np.ndarray, K: int, cap: int):
    """Region auxes for the two-region src reduction.

    ``cut`` (edge index) / ``s1`` (segment index) mark the static meta/self
    boundary in src order: every edge < cut must carry a key < s1 and every
    edge >= cut a key >= s1 (the masked-edge convention makes per-block
    counts static, so this holds whenever the layout's meta capacities are
    tile-aligned). Returns ``(aux_lo, tail_ptr2)`` or ``(None, None)`` when
    the boundary or the region-1 rank cap doesn't hold (the caller falls
    back to the single-call aux). Region 1's aux has W = 2*cap, V = cap.
    """
    key = np.asarray(key_src_sorted, np.int64)
    E = key.shape[0]
    if not (0 < cut < E) or cut % K:
        return None, None
    if key[cut - 1] >= s1 or key[cut] < s1:
        return None, None
    aux_lo = pallas_seg_aux(key[:cut], s1, K, 2 * cap, v=cap)
    if aux_lo is None:
        return None, None
    tail_ptr2 = (np.asarray(seg_ptr_src[s1:], np.int64) - cut).astype(
        np.int32
    )
    return aux_lo, tail_ptr2


def pallas_tab_window_aux(
    tab_src_order: np.ndarray, num_blocks: int,
    L: int = RTE_MAX_LEN, K: int = PK, W: int = PW,
) -> Optional[PallasSegAux]:
    """Aux that reduces the TAB grouping directly on SRC-ORDERED data.

    In src order (sorted by ``gidx = block*C + src``) the meta block is
    contiguous, so ``tabidx = block*L + Δt`` has a bounded window per tile:
    ``loc = (block - tile_block)*W + Δt`` lies in ``[0, W + L)``. Unlike
    :func:`pallas_seg_aux`, ``loc`` is NOT sorted within a tile, and the
    output row ``b*W + Δt`` is shared by every tile of meta block ``b``: the
    aux is marked ``window`` and
    :func:`~pyhgt_tpu_torch.ops.pallas_seg.live_partials_pair` takes its
    accumulate-and-add path. The backward then never permutes its [E, D]
    tensors into tab order.

    Output row ``b*W + Δt`` holds the sum for tab row ``b*L + Δt``;
    ``ptr2[s] = (s//L)*W + s%L`` lets the plain level-2 combine pick them
    out. Returns None (callers fall back to the permute path) when a tile
    spans more than two blocks or a block is empty — only possible when the
    per-meta edge blocks are smaller than the tile (tiny layouts).
    """
    if W < L:
        raise ValueError(f"window W = {W} < table length {L}")
    E = tab_src_order.shape[0]
    if E % K:
        raise ValueError(f"edge count {E} not a multiple of the {K} tile")
    tiles = E // K
    block = (tab_src_order // L).astype(np.int64).reshape(tiles, K)
    delta = (tab_src_order % L).astype(np.int64).reshape(tiles, K)
    blk = block[:, 0].astype(np.int32)
    if (
        blk[0] != 0
        or np.any(block.max(axis=1) - blk > 1)
        or np.any(np.diff(blk) < 0)
        or np.any(np.diff(blk) > 1)
    ):
        return None
    loc = ((block - blk[:, None]) * W + delta).astype(np.int32)
    NB = num_blocks
    tail = np.minimum(blk[-1] + 1 + np.arange(NB - 1), NB - 1)
    blk_ext = np.concatenate([blk, tail]).astype(np.int32)
    s = np.arange(num_blocks * L + 1)
    ptr2 = ((s // L) * W + s % L).astype(np.int32)
    return PallasSegAux(loc=loc, blk=blk_ext, ptr2=ptr2, w=W, v=L,
                        window=True)


def _compact_tab(tabidx: np.ndarray, B: int, L: int, cap: int):
    """Per-block occupied-Δt compaction of the RTE table space.

    ``tabidx = block*L + Δt`` spans B*L rows, but real graphs occupy few Δt
    slots per block (the reference caps the span at 120,
    ``pyHGT/data.py:250``). Remapping Δt to its rank among the block's
    occupied slots shrinks the table space to B*cap.

    Returns ``(tabidx_c, tab_sel)`` — the remapped edge index and the
    [B*cap] original row per compact row (dead compact slots point at their
    block's last original slot; no edge maps there, so the forward never
    gathers them and the backward adds zeros) — or ``(None, None)`` when a
    block occupies more than ``cap`` slots (the caller keeps the uncompacted
    table). The remap is monotone, so an order sorted by ``tabidx`` stays
    sorted by ``tabidx_c``.
    """
    used = np.zeros(B * L, dtype=bool)
    used[tabidx] = True
    u2 = used.reshape(B, L)
    occ = u2.sum(axis=1)
    if int(occ.max(initial=0)) > cap:
        return None, None
    rank = np.cumsum(u2, axis=1) - 1                      # [B, L]
    slot_rank = np.where(u2, rank, 0).reshape(B * L)
    comp_of = (np.arange(B * L) // L * cap + slot_rank).astype(np.int32)
    tabidx_c = comp_of[tabidx]
    tab_sel = np.empty(B * cap, np.int32)
    for b in range(B):
        rows = np.flatnonzero(u2[b])
        tab_sel[b * cap: b * cap + len(rows)] = b * L + rows
        tab_sel[b * cap + len(rows): (b + 1) * cap] = b * L + (L - 1)
    return tabidx_c, tab_sel


def _tiled_aux(key_sorted: np.ndarray, num_segments: int, K: int = REDUCE_TILE):
    """Host aux for the hierarchical tiled reduction over one grouping.

    ``key_sorted [E]``: non-decreasing segment ids (sentinel
    ``num_segments`` for padding). Returns (tile_local [E], live_idx [M],
    live_key [M], live_last [M], seg_ptr2 [S+1]) with static
    M = num_segments + E//K (padded live rows point at the extra zero row
    ``E//K * K`` appended by the device op).
    """
    E = key_sorted.shape[0]
    if E % K:
        raise ValueError(f"edge count {E} not a multiple of the {K} tile")
    tiles = E // K
    k2 = key_sorted.reshape(tiles, K)
    new = np.ones((tiles, K), dtype=bool)
    new[:, 1:] = k2[:, 1:] != k2[:, :-1]
    rank = np.cumsum(new, axis=1) - 1
    tl = rank.reshape(E).astype(np.int32)

    pos = np.flatnonzero(new.reshape(E))          # first edge of each live row
    t_of = pos // K
    row = (t_of * K + tl[pos]).astype(np.int32)
    k_of = key_sorted[pos].astype(np.int32)
    last = (np.r_[pos[1:], E] - 1).astype(np.int32)

    M = num_segments + tiles
    n = len(pos)
    live_idx = np.full(M, tiles * K, dtype=np.int32)     # extra zero row
    live_key = np.full(M, num_segments, dtype=np.int32)  # sentinel
    live_last = np.full(M, E, dtype=np.int32)            # extra NEG row
    live_idx[:n] = row
    live_key[:n] = k_of
    live_last[:n] = last
    seg_ptr2 = np.searchsorted(live_key, np.arange(num_segments + 1)).astype(
        np.int32
    )
    return tl, live_idx, live_key, live_last, seg_ptr2


def sort_batch(batch: SubgraphBatch, layout: BatchLayout,
               em: Optional[EdgeStaticMeta] = None, **kw) -> SortedEdges:
    """:func:`sort_edges` of a batch's edge arrays."""
    return sort_edges(batch.edge_src, batch.edge_tgt, batch.edge_dt,
                      batch.edge_mask, layout, em, **kw)


def sort_edges(
    edge_src,
    edge_tgt,
    edge_dt,
    edge_mask,
    layout: BatchLayout,
    em: Optional[EdgeStaticMeta] = None,
    tgt_rank_cap: int = 0,
    tab_cap: int = 0,
    with_backward: bool = True,
    pk: Optional[int] = None,
    pw: Optional[int] = None,
    src_rank_cap: int = 0,
    src_split_cap: int = 0,
) -> SortedEdges:
    """Sort a batch's flat edge arrays by target and build the aux.
    ``with_backward=False`` leaves out the src/tab groupings that only the
    backward reads (a serving request sorts once and never differentiates).

    ``pk``/``pw`` override the kernel aux's tile K and output block W
    (default: the module constants ``PK``/``PW``; ``pw`` defaults to
    ``pk``; ``pk`` must be a multiple of ``REDUCE_TILE``).

    ``tgt_rank_cap`` builds the target aux with W = V = cap when every tile
    holds at most ``cap`` segments, else the legacy W = K aux. ``tab_cap``
    compacts the RTE table space when every block occupies at most ``cap``
    Δt slots. ``src_rank_cap`` adds the singleton-split src aux
    (:func:`pallas_seg_aux_split`, W = V = cap) and ``src_split_cap`` the
    two-region src aux (:func:`_src_split_aux`); each stays ``None`` when
    its cap does not hold for the batch.

    Masked edges keep their OWN meta-block's last slot in ``gidx`` /
    ``tabidx`` instead of a global sentinel (the JAX package's convention:
    it keeps its source/tab-order aux layout-static); their rows are zero,
    so sums are unchanged.
    """
    K = pk or PK
    W = pw or (pk or PW)
    if K % REDUCE_TILE:
        raise ValueError(f"kernel tile {K} is not a multiple of the "
                         f"{REDUCE_TILE} reduction tile")
    em = em or EdgeStaticMeta.from_layout(layout)
    T, C = layout.num_types, layout.node_cap
    N = T * C
    E = layout.num_edges
    B = len(layout.blocks)
    L = RTE_MAX_LEN
    R = layout.schema.num_relations

    src0 = np.asarray(edge_src)
    tgt = np.asarray(edge_tgt)
    dt0 = np.asarray(edge_dt)
    mask = np.asarray(edge_mask)

    key = np.where(mask, tgt, N).astype(np.int32)  # padding sorts last
    perm = np.argsort(key, kind="stable")
    src, tgt, mask, key = src0[perm], tgt[perm], mask[perm], key[perm]
    blk_e = em.edge_block[perm]
    gidx = (src0 + em.gather_off)[perm]
    gidx = np.where(mask, gidx, blk_e * C + (C - 1)).astype(np.int32)
    tabidx = (em.edge_block * L + dt0)[perm]
    tabidx = np.where(mask, tabidx, blk_e * L + (L - 1)).astype(np.int32)
    rel = em.edge_rel[perm]
    onehot = np.zeros((E, R), dtype=np.float32)
    onehot[np.arange(E), rel] = mask  # padded rows are all-zero

    # pad the flat edge axis to the kernel tile (extra edges are masked and
    # sort last, so every downstream pointer stays correct)
    padn = (-E) % K
    if padn:
        src = np.concatenate([src, np.zeros(padn, src.dtype)])
        tgt = np.concatenate([tgt, np.zeros(padn, tgt.dtype)])
        mask = np.concatenate([mask, np.zeros(padn, bool)])
        key = np.concatenate([key, np.full(padn, N, key.dtype)])
        gidx = np.concatenate([gidx, np.full(padn, B * C - 1, gidx.dtype)])
        tabidx = np.concatenate(
            [tabidx, np.full(padn, B * L - 1, tabidx.dtype)]
        )
        onehot = np.concatenate([onehot, np.zeros((padn, R), np.float32)])
    safe_tgt = np.where(mask, tgt, N - 1).astype(np.int32)

    if with_backward:
        # the tab order is taken on the uncompacted index (the compaction
        # below is monotone and keeps it sorted)
        perm_src = np.argsort(gidx.astype(np.int64), kind="stable").astype(
            np.int32)
        perm_tab = np.argsort(tabidx.astype(np.int64), kind="stable").astype(
            np.int32)

    # tab compaction: remap the tab grouping to per-block occupied-Δt ranks
    # BEFORE any tab aux is built; only the segment space (B*L -> B*Lt) and
    # the keys change
    tab_sel = None
    Lt = L
    if tab_cap and tab_cap % 8 == 0 and tab_cap < L:
        tabidx_c, tab_sel = _compact_tab(tabidx, B, L, tab_cap)
        if tabidx_c is not None:
            tabidx = tabidx_c
            Lt = tab_cap

    bwd = {}
    if with_backward:
        src_cut = src_s1 = 0
        if src_split_cap:
            # static meta/self boundary in src order (per-block counts are
            # static by the masked-edge convention; self blocks come last
            # in GraphSchema.build_blocks). Valid only when the meta
            # capacities happen to be tile-aligned: _src_split_aux checks.
            meta = [b for b in layout.blocks if b.meta.rel != SELF_REL]
            src_cut = sum(b.cap for b in meta)
            src_s1 = len(meta) * C
        bwd = _backward_aux(gidx, tabidx, safe_tgt, perm_src, perm_tab,
                            B=B, C=C, Lt=Lt, K=K, W=W,
                            src_rank_cap=src_rank_cap,
                            src_split_cap=src_split_cap, src_cut=src_cut,
                            src_s1=src_s1)

    tl_tgt, li_tgt, lk_tgt, ll_tgt, sp2_tgt = _tiled_aux(key, N)
    key64 = key.astype(np.int64)
    pseg_tgt = None
    if tgt_rank_cap:
        pseg_tgt = pallas_seg_aux(key64, N, K, tgt_rank_cap, v=tgt_rank_cap)
    if pseg_tgt is None:
        pseg_tgt = pallas_seg_aux(key64, N, K, W)

    return SortedEdges(
        edge_src=src.astype(np.int32),
        edge_tgt=safe_tgt,
        edge_mask=mask,
        gidx=gidx,
        tabidx=tabidx,
        rel_onehot=onehot,
        tl_tgt=tl_tgt,
        live_idx_tgt=li_tgt,
        live_key_tgt=lk_tgt,
        live_last_tgt=ll_tgt,
        seg_ptr2_tgt=sp2_tgt,
        pseg_tgt=pseg_tgt,
        tab_sel=tab_sel,
        **bwd,
    )


def _backward_aux(gidx, tabidx, safe_tgt, perm_src, perm_tab, *, B, C, Lt,
                  K=PK, W=PW, src_rank_cap=0, src_split_cap=0, src_cut=0,
                  src_s1=0):
    """The SortedEdges fields only the backward reads: the src (``gidx``)
    and tab (``tabidx``, already compacted to ``Lt`` slots per block)
    groupings' CSR pointers, tiled aux and kernel aux (legacy width: src
    tiles of degree-1 sources reach K distinct segments, so no rank cap
    holds there), the tab-window aux over src-ordered rows, and, when their
    caps are given and hold, the singleton-split and two-region src aux.
    The masked edges' own-block indexing keeps the src-order block
    boundaries equal to the static per-block capacities, which is what lets
    the window aux and the two-region boundary build."""
    key_src_sorted = gidx.astype(np.int64)[perm_src]
    key_tab_sorted = tabidx.astype(np.int64)[perm_tab]
    seg_ptr_src = np.searchsorted(
        key_src_sorted, np.arange(B * C + 1)).astype(np.int32)
    seg_ptr_tab = np.searchsorted(
        key_tab_sorted, np.arange(B * Lt + 1)).astype(np.int32)
    tl_src, li_src, _, _, sp2_src = _tiled_aux(key_src_sorted, B * C)
    tl_tab, li_tab, _, _, sp2_tab = _tiled_aux(key_tab_sorted, B * Lt)
    # the window's only W constraint is W >= Lt (its blocks are META blocks,
    # which advance by at most one per tile whatever W is)
    W_tab = ((Lt + 7) // 8) * 8
    pseg_src_lo = src_tail_ptr2 = None
    if src_split_cap and src_cut and src_s1:
        pseg_src_lo, src_tail_ptr2 = _src_split_aux(
            key_src_sorted, src_cut, src_s1, seg_ptr_src, K, src_split_cap)
    if pseg_src_lo is None:
        src_cut = src_s1 = 0
    pseg_src_multi = src_single_edges = src_single_inv = None
    if src_rank_cap:
        split = pallas_seg_aux_split(
            key_src_sorted, B * C, K, src_rank_cap, v=src_rank_cap,
            single_cap=max(len(gidx) // 8, src_rank_cap))
        if split is not None:
            pseg_src_multi, src_single_edges, src_single_inv = split
    return dict(
        perm_src=perm_src, seg_ptr_src=seg_ptr_src,
        perm_tab=perm_tab, seg_ptr_tab=seg_ptr_tab,
        tgt_src_order=safe_tgt[perm_src], tgt_tab_order=safe_tgt[perm_tab],
        tl_src=tl_src, live_idx_src=li_src, seg_ptr2_src=sp2_src,
        tl_tab=tl_tab, live_idx_tab=li_tab, seg_ptr2_tab=sp2_tab,
        pseg_src=pallas_seg_aux(key_src_sorted, B * C, K, W),
        pseg_tab=pallas_seg_aux(key_tab_sorted, B * Lt, K, W),
        ptab_src=(pallas_tab_window_aux(tabidx[perm_src], B, Lt, K, W_tab)
                  if K >= Lt else None),
        pseg_src_multi=pseg_src_multi, src_single_edges=src_single_edges,
        src_single_inv=src_single_inv, pseg_src_lo=pseg_src_lo,
        src_tail_ptr2=src_tail_ptr2, src_cut=src_cut, src_s1=src_s1,
    )
