"""ctypes binding: the C++ batch-prep primitives of the sorted-edge layout.

Counterpart of :mod:`pyhgt_tpu.sampling.native_batch`, over this package's
own copy of ``sortbatch.cpp``: drop-in replacements for the numpy hot spots
of :func:`pyhgt_tpu_torch.sampling.sorted_batch.sort_edges`. Every key is a
bounded int (flat node id / bank row / RTE-table row), so the argsorts
become stable counting sorts (O(E + S), the same permutations) and each
grouping's tiled and kernel aux builds in one C++ pass. Every output is
bit-identical to the numpy path's.

All functions raise when the library cannot build; callers gate on
:func:`native_available`. Each call into the library adds one to
:data:`pyhgt_tpu_torch.native.build.CALLS` under its C name.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from pyhgt_tpu_torch.native.build import CALLS, load_library
from pyhgt_tpu_torch.ops.pallas_seg import PallasSegAux


def native_available() -> bool:
    try:
        load_library()
        return True
    except Exception:
        return False


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def counting_sort(key: np.ndarray, num_segments: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Stable sort permutation + CSR seg_ptr for int keys in
    ``[0, num_segments]`` (the top value is the padding sentinel).

    Returns ``(perm [E] int32, seg_ptr [num_segments+1] int32)`` —
    bit-identical to ``np.argsort(key, kind='stable')`` +
    ``np.searchsorted(key[perm], np.arange(num_segments+1))``."""
    lib = load_library()
    key = _i32(key)
    E = key.shape[0]
    perm = np.empty(E, np.int32)
    seg_ptr = np.empty(num_segments + 1, np.int32)
    CALLS["sb_counting_sort"] += 1
    rc = lib.sb_counting_sort(_i32p(key), E, num_segments, _i32p(perm),
                              _i32p(seg_ptr))
    if rc != 0:
        raise ValueError(f"key out of [0, {num_segments}] range")
    return perm, seg_ptr


def permute_build(src0, tgt0, dt0, mask0, perm, edge_block, gather_off,
                  edge_rel, E_padded: int, *, C: int, L: int, R: int,
                  N: int, B: int):
    """Fused permute + gidx/tabidx/one-hot build + padding to the kernel
    tile — the numpy body of ``sort_edges`` between the target sort and the
    aux builds, in one C++ pass. Returns
    ``(src, tgt_safe, dt, mask, key, gidx, tabidx, onehot)``, all padded
    to ``E_padded``."""
    lib = load_library()
    src0, tgt0, dt0, perm = _i32(src0), _i32(tgt0), _i32(dt0), _i32(perm)
    edge_block, gather_off, edge_rel = (
        _i32(edge_block), _i32(gather_off), _i32(edge_rel))
    mask0 = np.ascontiguousarray(mask0, dtype=np.uint8)
    E0 = src0.shape[0]
    E = E_padded
    src = np.empty(E, np.int32)
    tgt_safe = np.empty(E, np.int32)
    dt = np.empty(E, np.int32)
    mask = np.empty(E, np.uint8)
    key = np.empty(E, np.int32)
    gidx = np.empty(E, np.int32)
    tabidx = np.empty(E, np.int32)
    onehot = np.empty((E, R), np.float32)
    u8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))  # noqa: E731
    CALLS["sb_permute_build"] += 1
    lib.sb_permute_build(
        _i32p(src0), _i32p(tgt0), _i32p(dt0), u8(mask0), _i32p(perm),
        _i32p(edge_block), _i32p(gather_off), _i32p(edge_rel),
        E0, E, C, L, R, N, B,
        _i32p(src), _i32p(tgt_safe), _i32p(dt), u8(mask), _i32p(key),
        _i32p(gidx), _i32p(tabidx),
        onehot.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return (src, tgt_safe, dt, mask.view(bool), key, gidx, tabidx, onehot)


def tiled_aux(key_sorted: np.ndarray, num_segments: int, K: int):
    """Native :func:`pyhgt_tpu_torch.sampling.sorted_batch._tiled_aux`."""
    lib = load_library()
    key_sorted = _i32(key_sorted)
    E = key_sorted.shape[0]
    if E % K:
        raise ValueError(f"edge count {E} not a multiple of the {K} tile")
    M = num_segments + E // K
    tl = np.empty(E, np.int32)
    live_idx = np.empty(M, np.int32)
    live_key = np.empty(M, np.int32)
    live_last = np.empty(M, np.int32)
    seg_ptr2 = np.empty(num_segments + 1, np.int32)
    CALLS["sb_tiled_aux"] += 1
    n = lib.sb_tiled_aux(_i32p(key_sorted), E, num_segments, K, _i32p(tl),
                         _i32p(live_idx), _i32p(live_key), _i32p(live_last),
                         _i32p(seg_ptr2))
    if n < 0:
        raise ValueError("live rows exceed the static bound")
    return tl, live_idx, live_key, live_last, seg_ptr2


def tab_window_aux(tab_src_order: np.ndarray, num_blocks: int, L: int,
                   K: int, W: int):
    """Native :func:`pyhgt_tpu_torch.sampling.sorted_batch.
    pallas_tab_window_aux`: ``None`` when the window structure does not
    hold (tiny layouts), as the numpy function does."""
    lib = load_library()
    if W < L:
        raise ValueError(f"window W = {W} < table length {L}")
    tab = _i32(tab_src_order)
    E = tab.shape[0]
    if E % K:
        raise ValueError(f"edge count {E} not a multiple of the {K} tile")
    tiles = E // K
    loc = np.empty((tiles, K), np.int32)
    blk_ext = np.empty(tiles + num_blocks - 1, np.int32)
    CALLS["sb_tab_window_aux"] += 1
    rc = lib.sb_tab_window_aux(_i32p(tab), E, num_blocks, L, K, W,
                               _i32p(loc), _i32p(blk_ext))
    if rc != 0:
        return None
    s = np.arange(num_blocks * L + 1)
    ptr2 = ((s // L) * W + s % L).astype(np.int32)
    return PallasSegAux(loc=loc, blk=blk_ext, ptr2=ptr2, w=W, v=L,
                        window=True)


def pallas_aux(key_sorted: np.ndarray, num_segments: int, K: int, W: int):
    """Native :func:`pyhgt_tpu_torch.sampling.sorted_batch.pallas_seg_aux`
    (legacy width: no rank cap, ``W >= K``)."""
    lib = load_library()
    key_sorted = _i32(key_sorted)
    E = key_sorted.shape[0]
    if E % K:
        raise ValueError(f"edge count {E} not a multiple of the {K} tile")
    if W < K:
        raise ValueError(f"W = {W} < V = {K}")
    tiles = E // K
    NB = (num_segments + tiles + W - 1) // W + 1
    loc = np.empty((tiles, K), np.int32)
    blk_ext = np.empty(tiles + NB - 1, np.int32)
    ptr2 = np.empty(num_segments + 1, np.int32)
    live_key_ext = np.empty(NB * W, np.int32)
    CALLS["sb_pallas_aux"] += 1
    n = lib.sb_pallas_aux(_i32p(key_sorted), E, num_segments, K, W, NB,
                          _i32p(loc), _i32p(blk_ext), _i32p(ptr2),
                          _i32p(live_key_ext))
    if n < 0:
        raise ValueError("live rows exceed NB*W")
    return PallasSegAux(loc=loc, blk=blk_ext, ptr2=ptr2,
                        live_key=live_key_ext, w=W)
