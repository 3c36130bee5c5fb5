"""Segment reductions over sorted edges — the port's hand-written kernels.

Counterpart of :mod:`pyhgt_tpu.ops.pallas_seg` (the module keeps the JAX
file's name so each counterpart is found by path). Six functions, one per
TPU kernel of that file:

- :func:`live_partials`, :func:`live_partials_pair`,
  :func:`live_partials_weighted`, :func:`live_partials_slab`: level 1 of the
  hierarchical segment sum. Per (tile, local segment rank), the partial sum
  of the tile's rows of that segment (of one tensor, of two under one aux,
  of ``head_expand(w) * v``, of the two lane halves of one slab), written to
  the row ``blk[t]*W + loc[t, k]`` of a ``[NB*W, D]`` f32 buffer whose other
  rows are zero. Level 2 (combining the live rows of each segment) stays
  plain torch: :func:`pyhgt_tpu_torch.ops.sorted_hgt.seg_sum_csr` over
  ``aux.ptr2``.
- :func:`segment_softmax_partials`: per (tile, rank) the bf16-rounded max
  and the sum of ``exp(att - max)`` of target-sorted logits, level 1 of the
  online segment softmax.
- :func:`head_sum_product`: ``[E, H]`` per-head lane sums of ``a * b``.

On a CUDA tensor each function launches its Hopper kernel
(``csrc/<name>.cu``, built by :mod:`~pyhgt_tpu_torch.ops.cuda_build`) or
raises, and adds one to its ``launches`` count; on a CPU tensor it runs its
``*_plain`` version, the same function in plain PyTorch. Host aux
construction lives in :mod:`pyhgt_tpu_torch.sampling.sorted_batch`
(``pallas_seg_aux``, ``pallas_seg_aux_split``, ``pallas_tab_window_aux``).

Three kinds of aux, marked by their constructors: **runs**
(``pallas_seg_aux``: ``loc`` sorted within a tile, every (tile, rank) owns
its output row); runs with **dead rows** (``pallas_seg_aux_split``,
``aux.dead_rows``: rows that bypass the kernel carry ``loc = -1`` and the
kernels skip them); and **window** (``pallas_tab_window_aux``,
``aux.window``: ``loc`` in any order, output rows shared by all tiles of a
block), which only the pair and the slab take.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from pyhgt_tpu_torch.ops import cuda_build
from pyhgt_tpu_torch.utils.counters import register

# Tile (K) and output-block (W) sizes of the host aux. They were chosen for
# the TPU kernel (its one-hot width is K + W); the port keeps them as the
# parity configuration so both packages build the same aux.
PK = 384
PW = 384

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_K = 12288  # the tile's loc row sits in 48 KB of shared memory
_MAX_SMEM = 227 * 1024  # shared memory one Hopper block may opt in to
_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _c_fn(name: str, argtypes: tuple, entry: str = "launch"):
    """``<name>_<entry>`` of the library built from ``csrc/<name>.cu``, its
    argument types set (once: the wrappers call it per launch)."""
    fn = getattr(cuda_build.load(name), f"{name}_{entry}")
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def _on(device: torch.device):
    """The context that makes ``device`` current for a launch: none when
    it already is (the C entry points launch on the current device)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@dataclasses.dataclass
class PallasSegAux:
    """Host-built aux for :func:`live_partials` over one grouping.

    ``loc [tiles, K]``: each edge's row within its tile's output window —
    its global live-row index minus ``blk[tile] * W``, in ``[0, W + V)``.
    ``blk [tiles + NB - 1]``: output block per tile (the trailing ``NB - 1``
    entries drove the TPU kernel's flush steps; here they only fix NB).
    ``ptr2 [S + 1]``: CSR over live rows per segment (level-2 combine).
    ``live_key [NB * W]``: segment id per output row (sentinel S for dead
    rows). ``w``: the output-block row count W. ``v``: the rank cap V, the
    most live rows any tile adds (0 = legacy: V = K). ``window``: ``loc`` is
    unsorted within a tile and the tiles of one block share output rows (the
    tab-window aux); only :func:`live_partials_pair` and
    :func:`live_partials_slab` take such an aux. ``dead_rows``: a runs aux
    whose ``loc`` is -1 on rows that bypass the kernel (the singleton-split
    aux); the kernels skip them.
    """

    loc: object
    blk: object
    ptr2: object
    live_key: Optional[object] = None
    w: int = 512
    v: int = 0
    window: bool = False
    dead_rows: bool = False
    # set by :meth:`to` once check_rows passed; the kernels take no other aux
    rows_checked: bool = dataclasses.field(default=False, repr=False)

    @property
    def num_blocks(self) -> int:
        return self.blk.shape[0] - self.loc.shape[0] + 1

    def to(self, device) -> "PallasSegAux":
        """Tensors on ``device``: loc/blk int32 (the kernel reads them),
        ptr2/live_key int64 (index tensors). The host arrays are checked
        first (:func:`check_rows`); an aux already made of tensors was
        checked when it was made and only moves."""
        if not isinstance(self.loc, torch.Tensor):
            check_rows(self)
        elif not self.rows_checked:
            raise ValueError("a tensor aux must come from PallasSegAux.to")

        def t(a, dt):
            if isinstance(a, torch.Tensor):
                return a.to(device=device, dtype=dt)
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)
        return dataclasses.replace(
            self,
            loc=t(self.loc, torch.int32), blk=t(self.blk, torch.int32),
            ptr2=t(self.ptr2, torch.int64),
            live_key=None if self.live_key is None
            else t(self.live_key, torch.int64),
            rows_checked=True,
        )


def check_rows(aux: PallasSegAux):
    """The kernels' precondition, on host (numpy) aux. Raises ValueError
    when it does not hold.

    Runs aux: within a tile ``loc`` never decreases and stays in the window
    ``[0, W + V)``; the tiles' rows ``blk[t]*W + loc`` increase strictly
    from one tile to the next; the last row lies inside the ``[NB*W]``
    output. Then each (tile, run) owns its row and no store leaves the
    buffer. With ``aux.dead_rows`` a ``loc`` of -1 marks a row the kernels
    skip, and the same contract holds over the other entries.

    Window aux (``aux.window``): ``loc`` in any order within ``[0, W + V)``;
    ``blk`` starts anywhere, never decreases and steps by at most one; every
    row ``blk[t]*W + loc`` lies inside the output. Rows are shared between
    tiles, so the kernel adds them atomically.

    A negative ``loc`` on an aux not marked ``dead_rows`` is refused, and
    so is a window aux with dead rows.
    """
    loc, blk = np.asarray(aux.loc), np.asarray(aux.blk)
    n_tiles, K = loc.shape
    if blk.shape[0] < n_tiles:
        raise ValueError("aux.blk shorter than the tile count")
    rows = blk[:n_tiles, None].astype(np.int64) * aux.w + loc
    lowest = -1 if aux.dead_rows and not aux.window else 0
    in_window = loc.min() >= lowest and loc.max() < aux.w + (aux.v or K)
    if aux.window:
        steps = np.diff(blk[:n_tiles])
        if (not in_window or blk[0] < 0 or np.any(steps < 0)
                or np.any(steps > 1)
                or rows.max() >= aux.num_blocks * aux.w):
            raise ValueError("aux rows break the window contract (loc in "
                             "[0, W + V), block steps of 0 or 1, in bounds)")
        return
    # the live entries in edge order: rows may repeat within a tile and must
    # grow from one tile to the next
    live = loc >= 0
    live_rows = rows[live]
    tile_of = np.broadcast_to(np.arange(n_tiles)[:, None], loc.shape)[live]
    step, same_tile = np.diff(live_rows), np.diff(tile_of) == 0
    if (not in_window
            or np.any(step[same_tile] < 0)
            or np.any(step[~same_tile] <= 0)
            or (live_rows.size and live_rows[-1] >= aux.num_blocks * aux.w)):
        raise ValueError("aux rows break the live_partials contract "
                         "(sorted ranks per tile, disjoint tiles, in bounds)")


def out_rows(aux: PallasSegAux) -> torch.Tensor:
    """[E] int64: the output row ``blk[t]*W + loc[t, k]`` of every edge
    (negative for a dead row)."""
    n_tiles = aux.loc.shape[0]
    rows = aux.blk[:n_tiles].long()[:, None] * aux.w + aux.loc.long()
    return torch.where(aux.loc < 0, -1, rows).reshape(-1)


def _add_rows(data: torch.Tensor, rows: torch.Tensor, n_out: int,
              dead_rows: bool = False):
    out = torch.zeros((n_out, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    data = data.float()
    if dead_rows:
        keep = rows >= 0
        rows, data = rows[keep], data[keep]
    return out.index_add_(0, rows, data)


def live_partials_plain(data: torch.Tensor, aux: PallasSegAux) -> torch.Tensor:
    """Plain PyTorch version of :func:`live_partials`: an f32
    ``index_add_`` of every row (but the aux's dead rows) into
    ``blk[t]*W + loc[t, k]``."""
    return _add_rows(data, out_rows(aux), aux.num_blocks * aux.w,
                     aux.dead_rows)


def live_partials_pair_plain(d1: torch.Tensor, d2: torch.Tensor,
                             aux: PallasSegAux):
    """Plain PyTorch version of :func:`live_partials_pair`: two f32
    ``index_add_`` into the rows ``blk[t]*W + loc[t, k]``. It does not care
    whether ``loc`` is sorted, so it serves the runs and the window aux."""
    rows, n_out = out_rows(aux), aux.num_blocks * aux.w
    return (_add_rows(d1, rows, n_out, aux.dead_rows),
            _add_rows(d2, rows, n_out, aux.dead_rows))


def _check(data: torch.Tensor, aux: PallasSegAux):
    if aux.window:
        raise ValueError("live_partials takes a runs aux; the window aux "
                         "goes through live_partials_pair")
    _check_common(data, aux)


def _check_common(data: torch.Tensor, aux: PallasSegAux):
    if data.dim() != 2:
        raise ValueError(f"live_partials takes 2-D data, got {tuple(data.shape)}")
    if data.dtype not in _DTYPE_CODE:
        raise TypeError(f"live_partials takes f32 or bf16 data, got {data.dtype}")
    n_tiles, K = aux.loc.shape
    E, D = data.shape
    if E != n_tiles * K:
        raise ValueError(f"data rows {E} != aux tiles {n_tiles} * {K}")
    vec = 16 // data.element_size()
    if D % vec:
        raise ValueError(f"row width {D} must be a multiple of {vec} "
                         f"({data.dtype} in 16-byte vectors)")
    if not 0 < K <= _MAX_K:
        raise ValueError(f"tile size {K} outside (0, {_MAX_K}]")
    _check_aux(data, aux)
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")


def _check_aux(data: torch.Tensor, aux: PallasSegAux):
    """What every kernel needs of its aux and of where its tensors lie."""
    if aux.w < (aux.v or aux.loc.shape[1]):
        raise ValueError(f"W = {aux.w} < V = {aux.v or aux.loc.shape[1]}")
    if not aux.rows_checked:
        raise ValueError("aux must come from PallasSegAux.to (rows checked)")
    for name, t in (("data", data), ("loc", aux.loc), ("blk", aux.blk)):
        if not isinstance(t, torch.Tensor) or t.device != data.device:
            raise ValueError(f"{name} must be a tensor on {data.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if aux.loc.dtype != torch.int32 or aux.blk.dtype != torch.int32:
        raise TypeError("aux.loc and aux.blk must be int32")


def _outputs(aux: PallasSegAux, D: int, n: int, device):
    """The kernels' ``n`` outputs ``[NB*W, D]`` f32, views of one
    allocation: uninitialised for a runs aux, whose walk writes every row
    itself (zeros included); zero-filled for a window aux (rows shared by
    tiles, added with atomics) and a dead-rows aux (an all-dead tile has no
    rows of its own to write)."""
    make = torch.zeros if aux.window or aux.dead_rows else torch.empty
    return make((n, aux.num_blocks * aux.w, D), dtype=torch.float32,
                device=device).unbind(0)


def _stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the raw ``cudaStream_t``
    the C entry points take."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(data: torch.Tensor, aux: PallasSegAux) -> torch.Tensor:
    fn = _c_fn("live_partials",
               (_PTR, _INT, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                _LONG, _PTR))
    n_tiles, K = aux.loc.shape
    D = data.shape[1]
    with _on(data.device):
        (out,) = _outputs(aux, D, 1, data.device)
        stream = _stream(data.device)
        err = fn(data.data_ptr(), _DTYPE_CODE[data.dtype],
                 aux.loc.data_ptr(), aux.blk.data_ptr(), out.data_ptr(),
                 n_tiles, K, D, aux.w, int(aux.dead_rows), out.shape[0],
                 stream)
    if err:
        raise RuntimeError(f"live_partials kernel launch failed: cudaError {err}")
    return out


def live_partials(data: torch.Tensor, aux: PallasSegAux) -> torch.Tensor:
    """Per-(tile, local-segment) partial sums of sorted ``data [E, D]``.

    Returns ``[NB * W, D]`` f32; row ``blk[t]*W + loc[t, k]`` holds the
    tile-t partial of edge k's segment (same ordering as the level-2 CSR
    ``aux.ptr2``); all other rows are zero. bf16 and f32 inputs both
    accumulate in f32. ``aux`` comes from :meth:`PallasSegAux.to`, which
    checked its rows (:func:`check_rows`). A CUDA tensor goes through the
    Hopper kernel (each launch adds one to ``live_partials.launches``); a
    CPU tensor through :func:`live_partials_plain`.
    """
    if data.device.type == "cpu":
        return live_partials_plain(data, aux)
    if data.device.type != "cuda":
        raise ValueError(f"live_partials runs on cuda or cpu, not {data.device}")
    _check(data, aux)
    out = _launch(data, aux)
    live_partials.launches += 1
    return out


live_partials.launches = 0


def _check_pair(d1: torch.Tensor, d2: torch.Tensor, aux: PallasSegAux):
    _check_common(d1, aux)
    if d2.dtype != d1.dtype or d2.device != d1.device:
        raise TypeError("the pair must share dtype and device, got "
                        f"{d1.dtype}/{d1.device} and {d2.dtype}/{d2.device}")
    if not d2.is_contiguous() or d2.data_ptr() % 16:
        raise ValueError("d2 must be contiguous and 16-byte aligned")
    _check_window_fits(aux)


def _check_window_fits(aux: PallasSegAux):
    """The window walk's sort (sorted loc and row [K] each, bins [W + V +
    1], in ints) must fit 48 KB of shared memory; with the row ring (at most
    16 KB, csrc/pair_walk.cuh) a block then stays far inside the 227 KB a
    Hopper block may opt in to."""
    K = aux.loc.shape[1]
    if aux.window and 2 * K + aux.w + (aux.v or K) + 1 > _MAX_K:
        raise ValueError(
            f"tile {K} and window {aux.w + (aux.v or K)}: the window "
            "kernel's sort does not fit 48 KB of shared memory")


# the PairKind values of csrc/pair_walk.cuh
PAIR_RUNS, PAIR_WINDOW, PAIR_RUNS_DEAD = 0, 1, 2


def _pair_kind(aux: PallasSegAux) -> int:
    """Which of the pair's (and the slab's) kernels an aux takes."""
    if aux.window:
        return PAIR_WINDOW
    return PAIR_RUNS_DEAD if aux.dead_rows else PAIR_RUNS


def _launch_pair(d1, d2, aux: PallasSegAux):
    fn = _c_fn("live_partials_pair",
               (_PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                _INT, _INT, _INT, _LONG, _PTR))
    n_tiles, K = aux.loc.shape
    D = d1.shape[1]
    with _on(d1.device):
        o1, o2 = _outputs(aux, D, 2, d1.device)
        stream = _stream(d1.device)
        err = fn(d1.data_ptr(), d2.data_ptr(), _DTYPE_CODE[d1.dtype],
                 aux.loc.data_ptr(), aux.blk.data_ptr(), o1.data_ptr(),
                 o2.data_ptr(), n_tiles, K, D, aux.w, aux.w + (aux.v or K),
                 _pair_kind(aux), o1.shape[0], stream)
    if err:
        raise RuntimeError(
            f"live_partials_pair kernel launch failed: cudaError {err}")
    return o1, o2


def live_partials_pair(d1: torch.Tensor, d2: torch.Tensor, aux: PallasSegAux):
    """Per-(tile, local-segment) partial sums of TWO same-shape sorted
    tensors under one aux, in one pass that reads ``loc`` once. Returns
    ``(p1, p2)``, each as :func:`live_partials` would return it for that
    tensor (``[NB * W, D]`` f32, accumulated in f32 from bf16 or f32 rows).

    ``aux`` is a runs aux or a window aux (``aux.window``), checked by
    :meth:`PallasSegAux.to`. With a window aux the rows are added to the
    output with f32 atomics, so the order of addition, and the last bits of
    the sums, change from run to run. Shapes that differ raise ValueError. A
    CUDA tensor goes through the Hopper kernel (each launch adds one to
    ``live_partials_pair.launches``, and one to
    ``live_partials_pair.window_launches`` if the aux was a window); a CPU
    tensor through :func:`live_partials_pair_plain`.
    """
    if d1.shape != d2.shape:
        raise ValueError(f"pair shapes differ: {tuple(d1.shape)} vs "
                         f"{tuple(d2.shape)}")
    n_tiles, K = aux.loc.shape
    if d1.dim() != 2 or d1.shape[0] != n_tiles * K:
        raise ValueError(f"data rows {tuple(d1.shape)} != aux tiles "
                         f"{n_tiles} * {K}")
    if d1.device.type == "cpu":
        return live_partials_pair_plain(d1, d2, aux)
    if d1.device.type != "cuda":
        raise ValueError(
            f"live_partials_pair runs on cuda or cpu, not {d1.device}")
    _check_pair(d1, d2, aux)
    out = _launch_pair(d1, d2, aux)
    live_partials_pair.launches += 1
    live_partials_pair.window_launches += int(aux.window)
    return out


live_partials_pair.launches = 0
live_partials_pair.window_launches = 0


# ------------------------------------------------------ live_partials_slab
def live_partials_slab_plain(data: torch.Tensor, aux: PallasSegAux):
    """Plain PyTorch version of :func:`live_partials_slab`: the pair's
    plain version on the two lane halves."""
    D = data.shape[1] // 2
    return live_partials_pair_plain(data[:, :D], data[:, D:], aux)


def _launch_slab(data, aux: PallasSegAux):
    fn = _c_fn("live_partials_slab",
               (_PTR, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                _INT, _INT, _LONG, _PTR))
    n_tiles, K = aux.loc.shape
    D = data.shape[1] // 2
    with _on(data.device):
        o1, o2 = _outputs(aux, D, 2, data.device)
        stream = _stream(data.device)
        err = fn(data.data_ptr(), _DTYPE_CODE[data.dtype], aux.loc.data_ptr(),
                 aux.blk.data_ptr(), o1.data_ptr(), o2.data_ptr(), n_tiles, K,
                 D, aux.w, aux.w + (aux.v or K), _pair_kind(aux), o1.shape[0],
                 stream)
    if err:
        raise RuntimeError(
            f"live_partials_slab kernel launch failed: cudaError {err}")
    return o1, o2


def live_partials_slab(data: torch.Tensor, aux: PallasSegAux):
    """Per-(tile, local-segment) partial sums of the two lane halves of
    sorted ``data [E, 2D]`` under one aux: ``(p1, p2)``, each ``[NB * W, D]``
    f32 as :func:`live_partials` would return it for that half. One pass
    over one tensor: the edge stage's ``slab`` backward concatenates g_k and
    g_v along the lanes so that it permutes rows once.

    ``aux`` is a runs aux or a window aux, as for
    :func:`live_partials_pair` (the window case adds with f32 atomics, so
    the last bits of its sums change from run to run). The lane count must
    split into two 128-aligned halves. A CUDA tensor goes through the Hopper
    kernel (each launch adds one to ``live_partials_slab.launches``, and one
    to ``live_partials_slab.window_launches`` if the aux was a window); a
    CPU tensor through :func:`live_partials_slab_plain`.
    """
    if data.dim() != 2 or data.shape[1] % 256:
        raise ValueError(f"slab lanes {tuple(data.shape)} must split into "
                         "128-aligned halves")
    n_tiles, K = aux.loc.shape
    if data.shape[0] != n_tiles * K:
        raise ValueError(f"data rows {data.shape[0]} != aux tiles "
                         f"{n_tiles} * {K}")
    if data.device.type == "cpu":
        return live_partials_slab_plain(data, aux)
    if data.device.type != "cuda":
        raise ValueError(
            f"live_partials_slab runs on cuda or cpu, not {data.device}")
    _check_common(data, aux)
    _check_window_fits(aux)
    out = _launch_slab(data, aux)
    live_partials_slab.launches += 1
    live_partials_slab.window_launches += int(aux.window)
    return out


live_partials_slab.launches = 0
live_partials_slab.window_launches = 0


# ----------------------------------------------------- the walks' launches
_PLAN_KEYS = ("split", "grid_x", "grid_y", "threads", "smem_bytes",
              "stage_rows", "row_by_row")


def walk_plan(name: str, data: torch.Tensor, aux: PallasSegAux) -> dict:
    """The launch that ``name`` (``live_partials``, ``live_partials_pair``
    or ``live_partials_slab``) makes for ``data`` (the slab: the whole
    ``[E, 2D]`` slab) under ``aux`` on the current CUDA device, as
    csrc/pair_walk.cuh plans it: ``split`` (S, the blocks of one tile's
    cluster), the grid, threads per block, shared memory, rows per stage of
    the copy ring and whether rows are copied one by one. For records and
    logs; the wrappers do not call it."""
    n_tiles, K = aux.loc.shape
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    dtype = _DTYPE_CODE[data.dtype]
    D = data.shape[1] // 2 if name == "live_partials_slab" else data.shape[1]
    if name == "live_partials":
        err = _c_fn(name, (_INT,) * 5 + (_PTR,), "plan")(
            dtype, n_tiles, K, D, int(aux.dead_rows), out)
    else:
        err = _c_fn(name, (_INT,) * 6 + (_PTR,), "plan")(
            dtype, n_tiles, K, D, aux.w + (aux.v or K), _pair_kind(aux), out)
    if err:
        raise RuntimeError(f"{name}_plan failed: cudaError {err}")
    return dict(zip(_PLAN_KEYS, out))


# -------------------------------------------------- live_partials_weighted
def live_partials_weighted_plain(w: torch.Tensor, v: torch.Tensor, dk: int,
                                 aux: PallasSegAux) -> torch.Tensor:
    """Plain PyTorch version of :func:`live_partials_weighted`: the f32
    product ``head_expand(w) * v`` through :func:`live_partials_plain`."""
    msg = w.float().repeat_interleave(dk, dim=1) * v.float()
    return live_partials_plain(msg, aux)


def _launch_weighted(w, v, dk, aux: PallasSegAux):
    fn = _c_fn("live_partials_weighted",
               (_PTR, _PTR, _INT, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                _INT, _INT, _PTR))
    n_tiles, K = aux.loc.shape
    D = v.shape[1]
    with _on(v.device):
        out = torch.zeros((aux.num_blocks * aux.w, D), dtype=torch.float32,
                          device=v.device)
        stream = _stream(v.device)
        err = fn(w.data_ptr(), v.data_ptr(), _DTYPE_CODE[v.dtype],
                 aux.loc.data_ptr(), aux.blk.data_ptr(), out.data_ptr(),
                 n_tiles, K, D, D // dk, aux.w, int(aux.dead_rows), stream)
    if err:
        raise RuntimeError(
            f"live_partials_weighted kernel launch failed: cudaError {err}")
    return out


def live_partials_weighted(w: torch.Tensor, v: torch.Tensor, dk: int,
                           aux: PallasSegAux) -> torch.Tensor:
    """Per-(tile, local-segment) partial sums of the weighted messages
    ``head_expand(w) * v``: :func:`live_partials` with the per-edge product
    formed in the kernel, so the ``[E, D]`` message tensor is never written.
    ``w [E, H]`` f32 per-head scalars, ``v [E, D]`` f32 or bf16 values with
    ``D = H * dk``, both in the aux's edge order; product and sum in f32.
    ``aux`` is a runs aux. A CUDA tensor goes through the Hopper kernel
    (each launch adds one to ``live_partials_weighted.launches``); a CPU
    tensor through :func:`live_partials_weighted_plain`.
    """
    if v.dim() != 2 or dk <= 0 or v.shape[1] % dk:
        raise ValueError(f"v {tuple(v.shape)} does not split into heads of "
                         f"{dk} lanes")
    E, D = v.shape
    if tuple(w.shape) != (E, D // dk):
        raise ValueError(f"w {tuple(w.shape)} != ({E}, {D // dk})")
    n_tiles, K = aux.loc.shape
    if E != n_tiles * K:
        raise ValueError(f"data rows {E} != aux tiles {n_tiles} * {K}")
    if v.device.type == "cpu":
        return live_partials_weighted_plain(w, v, dk, aux)
    if v.device.type != "cuda":
        raise ValueError(
            f"live_partials_weighted runs on cuda or cpu, not {v.device}")
    _check(v, aux)
    vec = 16 // v.element_size()
    if dk % vec:
        raise ValueError(f"head width {dk} must be a multiple of {vec}: a "
                         "thread's 16-byte vector lies inside one head")
    if (w.dtype != torch.float32 or w.device != v.device
            or not w.is_contiguous()):
        raise TypeError("w must be a contiguous float32 tensor on v's device")
    out = _launch_weighted(w, v, dk, aux)
    live_partials_weighted.launches += 1
    return out


live_partials_weighted.launches = 0


# -------------------------------------------------------- head_sum_product
def head_sum_product_plain(a: torch.Tensor, b: torch.Tensor,
                           dk: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`head_sum_product`: the f32 product,
    then each head's lane sum."""
    E, D = a.shape
    return (a.float() * b.float()).reshape(E, D // dk, dk).sum(-1)


def head_sum_product(a: torch.Tensor, b: torch.Tensor, dk: int) -> torch.Tensor:
    """Per-head reduction ``[E, H] = sum over each head's dk lanes of
    a * b`` (f32) without writing the ``[E, D]`` product. ``a`` and ``b``
    ``[E, D]``, both f32 or both bf16. As in the JAX package, shapes that
    differ, ``E`` not a multiple of ``PK`` or ``D`` not a multiple of ``dk``
    raise ValueError. A CUDA tensor goes through the Hopper kernel (each
    launch adds one to ``head_sum_product.launches``); a CPU tensor through
    :func:`head_sum_product_plain`.
    """
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.dim() != 2:
        raise ValueError(f"head_sum_product takes 2-D data, got "
                         f"{tuple(a.shape)}")
    E, D = a.shape
    if E % PK or dk <= 0 or D % dk:
        raise ValueError(f"E={E} not a multiple of {PK} or D={D} % dk")
    if a.device.type == "cpu":
        return head_sum_product_plain(a, b, dk)
    if a.device.type != "cuda":
        raise ValueError(
            f"head_sum_product runs on cuda or cpu, not {a.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError("head_sum_product takes two f32 or two bf16 tensors, "
                        f"got {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError("a and b must lie on one device")
    vec = 16 // a.element_size()
    group = dk // vec
    if dk % vec or group > 32 or group & (group - 1):
        raise ValueError(f"head width {dk}: dk / {vec} must be a power of "
                         "two up to 32 (the lanes of a head share a warp)")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    fn = _c_fn("head_sum_product",
               (_PTR, _PTR, _INT, _PTR, _LONG, _INT, _INT, _PTR))
    with _on(a.device):
        out = torch.empty((E, D // dk), dtype=torch.float32, device=a.device)
        stream = _stream(a.device)
        err = fn(a.data_ptr(), b.data_ptr(), _DTYPE_CODE[a.dtype],
                 out.data_ptr(), E, D, dk, stream)
    if err:
        raise RuntimeError(
            f"head_sum_product kernel launch failed: cudaError {err}")
    head_sum_product.launches += 1
    return out


head_sum_product.launches = 0


# ------------------------------------------------ segment_softmax_partials
def segment_softmax_partials_plain(att: torch.Tensor, aux: PallasSegAux):
    """Plain PyTorch version of :func:`segment_softmax_partials`: a
    scatter-max of every row into ``blk[t]*W + loc[t, k]``, its bf16
    rounding, and an ``index_add_`` of the gated ``exp``."""
    rows = out_rows(aux)
    n_out, H = aux.num_blocks * aux.w, att.shape[1]
    att = att.float()
    idx = rows[:, None].expand(-1, H)
    m = torch.zeros((n_out, H), dtype=torch.float32, device=att.device)
    m.scatter_reduce_(0, idx, att, "amax", include_self=False)
    m = m.to(torch.bfloat16).float()        # round to nearest even
    ex = torch.where(att > -5e29,
                     torch.exp(torch.clamp(att - m[rows], max=80.0)),
                     torch.zeros_like(att))
    s = torch.zeros_like(m).index_add_(0, rows, ex)
    return m, s


@functools.lru_cache(maxsize=None)
def _softmax_smem_bytes(K: int, H: int, window: int) -> int:
    """Shared memory one block of the softmax kernel takes for a tile."""
    fn = getattr(cuda_build.load("segment_softmax_partials"),
                 "segment_softmax_partials_smem")
    fn.restype, fn.argtypes = ctypes.c_longlong, [_INT, _INT, _INT]
    return fn(K, H, window)


def segment_softmax_partials(att: torch.Tensor, aux: PallasSegAux):
    """Per-(tile, local-segment) online-softmax partials of target-sorted
    logits ``att [E, H]`` (f32; masked edges carry -1e30).

    Returns ``(m_rows, s_rows)``, both ``[NB * W, H]`` f32: for the live row
    ``blk[t]*W + loc`` of a (tile, segment) slice, ``m_rows`` holds the bf16
    rounding (to nearest even, kept as f32) of the slice's max and
    ``s_rows`` the sum over the slice of ``exp(min(att - m, 80))``, with
    rows at or below -5e29 adding nothing; rows no slice reaches are 0 in
    both. A slice of masked rows only has a finite ``m`` and ``s = 0``. The
    caller merges rows per segment
    (:func:`pyhgt_tpu_torch.ops.sorted_hgt._softmax_pallas`); since this
    ``exp`` and that merge use the same rounded max, the softmax is exact
    up to f32 rounding.

    ``aux`` is a runs aux without dead rows. A CUDA tensor goes through the
    Hopper kernel, one launch that writes every output row itself (each
    launch adds one to ``segment_softmax_partials.launches``); a CPU tensor
    through :func:`segment_softmax_partials_plain`.
    """
    if att.dim() != 2:
        raise ValueError(f"att must be [E, H], got {tuple(att.shape)}")
    E, H = att.shape
    n_tiles, K = aux.loc.shape
    if E != n_tiles * K:
        raise ValueError(f"att rows {E} != aux tiles {n_tiles} * {K}")
    if aux.window or aux.dead_rows:
        raise ValueError("segment_softmax_partials takes a runs aux without "
                         "dead rows")
    if att.device.type == "cpu":
        return segment_softmax_partials_plain(att, aux)
    if att.device.type != "cuda":
        raise ValueError(
            f"segment_softmax_partials runs on cuda or cpu, not {att.device}")
    if att.dtype != torch.float32:
        raise TypeError(f"att must be float32, got {att.dtype}")
    _check_aux(att, aux)
    if K % 4 or K > 1024 or att.data_ptr() % 16 or aux.loc.data_ptr() % 16:
        raise ValueError(f"the kernel loads 16-byte vectors and gives each "
                         f"lane at most 32 rows: tile {K} must be a multiple "
                         "of 4 up to 1024, att and loc 16-byte aligned")
    n_out = aux.num_blocks * aux.w
    if n_out * H >= 2**31:
        raise ValueError(f"{n_out} x {H} output words exceed int32")
    window = aux.w + (aux.v or K)
    smem = _softmax_smem_bytes(K, H, window)
    if smem > _MAX_SMEM:
        raise ValueError(f"a tile of {K} x {H} logits takes {smem} bytes of "
                         f"shared memory, over {_MAX_SMEM}")
    fn = _c_fn("segment_softmax_partials",
               (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                _LONG, _PTR))
    with _on(att.device):
        # every row is written by the kernel: no fill
        m = torch.empty((n_out, H), dtype=torch.float32, device=att.device)
        s = torch.empty((n_out, H), dtype=torch.float32, device=att.device)
        stream = _stream(att.device)
        err = fn(att.data_ptr(), aux.loc.data_ptr(), aux.blk.data_ptr(),
                 m.data_ptr(), s.data_ptr(), n_tiles, K, H, aux.w, window,
                 n_out, stream)
    if err:
        raise RuntimeError(
            f"segment_softmax_partials kernel launch failed: cudaError {err}")
    segment_softmax_partials.launches += 1
    return m, s


segment_softmax_partials.launches = 0

# every kernel source under csrc/, in the order of the JAX package's kernels
KERNEL_SOURCES = (
    "live_partials", "live_partials_pair", "segment_softmax_partials",
    "head_sum_product", "live_partials_weighted", "live_partials_slab",
)
# a CUDA graph's replay advances each kernel's launch counters
for _name in KERNEL_SOURCES:
    _fn = globals()[_name]
    register(_fn, *(c for c in ("launches", "window_launches")
                    if hasattr(_fn, c)))
