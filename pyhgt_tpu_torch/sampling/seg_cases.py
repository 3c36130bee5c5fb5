"""Hard layouts for the segment-sum kernels: a few tiles of each aux shape
that stresses how a kernel splits and joins a tile's rows.

:func:`adversarial_auxes` builds, from a seed and with numpy only, host
aux of ``n_tiles`` tiles of ``K`` rows for
:func:`~pyhgt_tpu_torch.ops.pallas_seg.live_partials` and its pair and slab
(the window case only for those two). Each case repeats its pattern every
six tiles, so a caller picks how many tiles, and with them how many blocks
share one tile on the card (csrc/pair_walk.cuh splits a tile over 8 blocks
below 66 tiles on 132 SMs, over 4 below 132 and over 2 below 264):

- ``whole-tile``: every tile one run of K rows, one run over two tiles
  (legacy ``W = K`` runs aux);
- ``cross-chunk``: runs of 48 rows starting 24 rows into the tile, so a run
  crosses every multiple of 48: every boundary between the blocks of a
  split tile;
- ``row-per-run``: K distinct keys per tile, one row per run;
- ``gaps``: a runs aux whose rows skip values inside and between tiles
  (``loc`` steps by 1-3; ``W = V = 4K``), which the host constructors never
  make but the kernels' contract (``check_rows``) allows;
- ``dead``: the singleton-split aux (``dead_rows``), tiles of short runs,
  of singletons only (all rows dead) and of long runs in turn;
- ``window``: the tab-window aux at ``W = V = 240`` over blocks of 1.5, 2
  and 2.5 tiles.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pyhgt_tpu_torch.ops.pallas_seg import PK, PallasSegAux
from pyhgt_tpu_torch.sampling.sorted_batch import (
    pallas_seg_aux, pallas_seg_aux_split, pallas_tab_window_aux,
)

CASES = ("whole-tile", "cross-chunk", "row-per-run", "gaps", "dead",
         "window")
WINDOW_L = 240


def _keys_from_runs(lengths: np.ndarray, E: int) -> np.ndarray:
    """Consecutive keys, one per run of ``lengths``, cut to ``E`` rows."""
    return np.repeat(np.arange(len(lengths)), lengths)[:E].astype(np.int64)


def _region_runs(rng, sizes, lows, highs) -> np.ndarray:
    """Run lengths filling each region of ``sizes`` rows exactly, drawn from
    ``[low, high)`` per region (the last run of a region is cut)."""
    out = []
    for size, lo, hi in zip(sizes, lows, highs):
        lengths = rng.integers(lo, hi, size=size)   # enough: each >= 1
        ends = np.cumsum(lengths)
        n = int(np.searchsorted(ends, size)) + 1
        lengths = lengths[:n]
        lengths[-1] -= ends[n - 1] - size
        out.append(lengths)
    return np.concatenate(out)


def _gaps_aux(rng, n_tiles: int, K: int) -> PallasSegAux:
    """Runs of 1-40 rows whose output rows step by 1-3 within a tile and
    by 1-4 from one tile to the next."""
    E = n_tiles * K
    key = _keys_from_runs(_region_runs(rng, [E], [1], [41]), E).reshape(
        n_tiles, K)
    W = 4 * K
    loc = np.empty((n_tiles, K), np.int64)
    blk = np.empty(n_tiles, np.int64)
    row = 0
    for t in range(n_tiles):
        new = np.ones(K, bool)
        new[1:] = key[t, 1:] != key[t, :-1]
        steps = np.where(new, rng.integers(1, 4, size=K), 0)
        steps[0] = 0
        rows = row + np.cumsum(steps)
        blk[t] = row // W
        loc[t] = rows - blk[t] * W
        row = int(rows[-1]) + int(rng.integers(1, 5))
    nb = row // W + 2
    tail = np.minimum(blk[-1] + 1 + np.arange(nb - 1), nb - 1)
    return PallasSegAux(loc=loc.astype(np.int32),
                        blk=np.concatenate([blk, tail]).astype(np.int32),
                        ptr2=np.zeros(1, np.int32), w=W, v=W)


def adversarial_auxes(n_tiles: int = 6, K: int = PK,
                      seed: int = 0) -> Dict[str, PallasSegAux]:
    """The cases of the module docstring, each over ``n_tiles`` tiles (a
    multiple of 6) of ``K`` rows (a multiple of 48), as host (numpy) aux."""
    if n_tiles % 6 or K % 48:
        raise ValueError(f"{n_tiles} tiles of {K}: need multiples of 6 and 48")
    rng = np.random.default_rng(seed)
    E = n_tiles * K
    out = {}
    key = np.arange(E) // K
    key[(key % 6) == 2] -= 1                      # tiles 1-2 of every six
    out["whole-tile"] = pallas_seg_aux(key, int(key.max()) + 1, K, K)
    key = (np.arange(E) + 24) // 48
    out["cross-chunk"] = pallas_seg_aux(key, int(key.max()) + 1, K, K)
    key = np.arange(E)
    out["row-per-run"] = pallas_seg_aux(key, E, K, K)
    out["gaps"] = _gaps_aux(rng, n_tiles, K)
    # tiles of short runs, of singletons, of long runs, in turn
    pattern = [(1, 6), (1, 2), (2, 100)]
    lows, highs = zip(*[pattern[t % 3] for t in range(n_tiles)])
    key = _keys_from_runs(_region_runs(rng, [K] * n_tiles, lows, highs), E)
    split = pallas_seg_aux_split(key, int(key.max()) + 1, K=K, W=K, v=K,
                                 single_cap=E)
    out["dead"] = split[0]
    sizes = [3 * K // 2, 2 * K, 5 * K // 2] * (n_tiles // 6)
    tab = np.concatenate([b * WINDOW_L + rng.integers(0, WINDOW_L, size=s)
                          for b, s in enumerate(sizes)]).astype(np.int64)
    out["window"] = pallas_tab_window_aux(tab, len(sizes), WINDOW_L, K,
                                          WINDOW_L)
    return out


def segment_sum_f64(data: np.ndarray, aux: PallasSegAux):
    """The reference sum in float64 numpy: every live row of ``data``
    (``loc >= 0``) added into its output row ``blk[t]*W + loc``. Returns the
    ``[NB*W, D]`` sums and the sums of the terms' magnitudes."""
    n_tiles = aux.loc.shape[0]
    rows = (np.asarray(aux.blk[:n_tiles], np.int64)[:, None] * aux.w
            + aux.loc).reshape(-1)
    live = aux.loc.reshape(-1) >= 0
    out = np.zeros((aux.num_blocks * aux.w, data.shape[1]))
    mag = np.zeros_like(out)
    np.add.at(out, rows[live], data[live].astype(np.float64))
    np.add.at(mag, rows[live], np.abs(data[live]).astype(np.float64))
    return out, mag


def on_nan_memory(fn, shapes):
    """``fn()`` right after CUDA tensors of ``shapes`` full of NaN were
    freed, so that the caching allocator hands that memory to its outputs
    (checked: each output lies inside one of them): a kernel that leaves a
    row unwritten shows NaN there. A wrapper that makes its outputs as
    views of one allocation is baited with one tensor of that shape."""
    bait = [torch.full(s, float("nan"), device="cuda") for s in shapes]
    spans = [(b.data_ptr(), b.data_ptr() + b.numel() * b.element_size())
             for b in bait]
    del bait
    out = fn()
    for o in out if isinstance(out, tuple) else (out,):
        lo, hi = o.data_ptr(), o.data_ptr() + o.numel() * o.element_size()
        if not any(a <= lo and hi <= b for a, b in spans):
            raise AssertionError("an output did not land on the NaN memory")
    return out
