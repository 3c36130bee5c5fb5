"""Segment sums over sorted edges — the ``live_partials`` kernels.

Counterpart of :mod:`pyhgt_tpu.ops.pallas_seg` (its ``live_partials`` and
``live_partials_pair``; the module keeps the JAX file's name so each
counterpart is found by path). Level 1 of the hierarchical segment sum: per
(tile, local segment rank), the partial sum of the tile's rows of that
segment, written to the row ``blk[t]*W + loc[t, k]`` of a ``[NB*W, D]`` f32
buffer whose other rows are zero. Level 2 (combining the live rows of each
segment) stays plain torch:
:func:`pyhgt_tpu_torch.ops.sorted_hgt.seg_sum_csr` over ``aux.ptr2``.

On a CUDA tensor :func:`live_partials` and :func:`live_partials_pair` launch
the hand-written Hopper kernels ``csrc/live_partials.cu`` and
``csrc/live_partials_pair.cu`` or raise; on a CPU tensor they run
:func:`live_partials_plain` and :func:`live_partials_pair_plain`, the same
functions in plain PyTorch. Host aux construction lives in
:mod:`pyhgt_tpu_torch.sampling.sorted_batch` (``pallas_seg_aux``,
``pallas_tab_window_aux``).

Two kinds of aux reach the pair: **runs** (``pallas_seg_aux``: ``loc``
sorted within a tile, every (tile, rank) owns its output row) and
**window** (``pallas_tab_window_aux``, ``aux.window``: ``loc`` in any
order, output rows shared by all tiles of a block). The aux's constructor
marks which; the single-tensor kernel takes runs only. The singleton-split
aux of the JAX package (``pallas_seg_aux_split``, negative ``loc`` for rows
that bypass the kernel) is not ported: :func:`check_rows` refuses a negative
``loc``, and a port of that aux must give the kernels a dead row to skip.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from pyhgt_tpu_torch.ops import cuda_build

# Tile (K) and output-block (W) sizes of the host aux. They were chosen for
# the TPU kernel (its one-hot width is K + W); the port keeps them as the
# parity configuration so both packages build the same aux.
PK = 384
PW = 384

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_K = 12288  # the tile's loc row sits in 48 KB of shared memory


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
    tab-window aux); only :func:`live_partials_pair` takes such an aux.
    """

    loc: object
    blk: object
    ptr2: object
    live_key: Optional[object] = None
    w: int = 512
    v: int = 0
    window: bool = False
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
    buffer.

    Window aux (``aux.window``): ``loc`` in any order within ``[0, W + V)``;
    ``blk`` starts anywhere, never decreases and steps by at most one; every
    row ``blk[t]*W + loc`` lies inside the output. Rows are shared between
    tiles, so the kernel adds them atomically.

    A negative ``loc`` (the JAX package's singleton-split aux marks rows
    that bypass the kernel so) is refused in both cases.
    """
    loc, blk = np.asarray(aux.loc), np.asarray(aux.blk)
    n_tiles, K = loc.shape
    if blk.shape[0] < n_tiles:
        raise ValueError("aux.blk shorter than the tile count")
    rows = blk[:n_tiles, None].astype(np.int64) * aux.w + loc
    in_window = loc.min() >= 0 and loc.max() < aux.w + (aux.v or K)
    if aux.window:
        steps = np.diff(blk[:n_tiles])
        if (not in_window or blk[0] < 0 or np.any(steps < 0)
                or np.any(steps > 1)
                or rows.max() >= aux.num_blocks * aux.w):
            raise ValueError("aux rows break the window contract (loc in "
                             "[0, W + V), block steps of 0 or 1, in bounds)")
        return
    if (not in_window
            or np.any(np.diff(loc, axis=1) < 0)
            or np.any(rows[1:, 0] <= rows[:-1, -1])
            or rows[-1, -1] >= aux.num_blocks * aux.w):
        raise ValueError("aux rows break the live_partials contract "
                         "(sorted ranks per tile, disjoint tiles, in bounds)")


def out_rows(aux: PallasSegAux) -> torch.Tensor:
    """[E] int64: the output row ``blk[t]*W + loc[t, k]`` of every edge."""
    n_tiles = aux.loc.shape[0]
    rows = aux.blk[:n_tiles].long()[:, None] * aux.w + aux.loc.long()
    return rows.reshape(-1)


def _add_rows(data: torch.Tensor, rows: torch.Tensor, n_out: int):
    out = torch.zeros((n_out, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    return out.index_add_(0, rows, data.float())


def live_partials_plain(data: torch.Tensor, aux: PallasSegAux) -> torch.Tensor:
    """Plain PyTorch version of :func:`live_partials`: an f32
    ``index_add_`` of every row into ``blk[t]*W + loc[t, k]``."""
    return _add_rows(data, out_rows(aux), aux.num_blocks * aux.w)


def live_partials_pair_plain(d1: torch.Tensor, d2: torch.Tensor,
                             aux: PallasSegAux):
    """Plain PyTorch version of :func:`live_partials_pair`: two f32
    ``index_add_`` into the rows ``blk[t]*W + loc[t, k]``. It does not care
    whether ``loc`` is sorted, so it serves the runs and the window aux."""
    rows, n_out = out_rows(aux), aux.num_blocks * aux.w
    return _add_rows(d1, rows, n_out), _add_rows(d2, rows, n_out)


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
    if aux.w < (aux.v or K):
        raise ValueError(f"W = {aux.w} < V = {aux.v or K}")
    if not aux.rows_checked:
        raise ValueError("aux must come from PallasSegAux.to (rows checked)")
    for name, t in (("data", data), ("loc", aux.loc), ("blk", aux.blk)):
        if not isinstance(t, torch.Tensor) or t.device != data.device:
            raise ValueError(f"{name} must be a tensor on {data.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if aux.loc.dtype != torch.int32 or aux.blk.dtype != torch.int32:
        raise TypeError("aux.loc and aux.blk must be int32")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")


def _launch(data: torch.Tensor, aux: PallasSegAux) -> torch.Tensor:
    lib = cuda_build.load("live_partials")
    fn = lib.live_partials_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    n_tiles, K = aux.loc.shape
    D = data.shape[1]
    with torch.cuda.device(data.device):
        out = torch.zeros((aux.num_blocks * aux.w, D), dtype=torch.float32,
                          device=data.device)
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), _DTYPE_CODE[data.dtype],
                 aux.loc.data_ptr(), aux.blk.data_ptr(), out.data_ptr(),
                 n_tiles, K, D, aux.w, stream)
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
    K = aux.loc.shape[1]
    if aux.window and 2 * K + aux.w + (aux.v or K) + 1 > _MAX_K:
        raise ValueError(
            f"tile {K} and window {aux.w + (aux.v or K)}: the window "
            "kernel's sort does not fit 48 KB of shared memory")


def _launch_pair(d1, d2, aux: PallasSegAux):
    lib = cuda_build.load("live_partials_pair")
    fn = lib.live_partials_pair_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    n_tiles, K = aux.loc.shape
    D = d1.shape[1]
    with torch.cuda.device(d1.device):
        shape = (aux.num_blocks * aux.w, D)
        o1 = torch.zeros(shape, dtype=torch.float32, device=d1.device)
        o2 = torch.zeros(shape, dtype=torch.float32, device=d1.device)
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        err = fn(d1.data_ptr(), d2.data_ptr(), _DTYPE_CODE[d1.dtype],
                 aux.loc.data_ptr(), aux.blk.data_ptr(), o1.data_ptr(),
                 o2.data_ptr(), n_tiles, K, D, aux.w, aux.w + (aux.v or K),
                 int(aux.window), stream)
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
