"""Segment sums over sorted edges — the ``live_partials`` kernel.

Counterpart of :mod:`pyhgt_tpu.ops.pallas_seg` (its ``live_partials``;
the module keeps the JAX file's name so each counterpart is found by path).
Level 1 of the hierarchical segment sum: per (tile, local segment rank),
the partial sum of the tile's rows of that segment, written to the row
``blk[t]*W + loc[t, k]`` of a ``[NB*W, D]`` f32 buffer whose other rows are
zero. Level 2 (combining the live rows of each segment) stays plain torch:
:func:`pyhgt_tpu_torch.ops.sorted_hgt.seg_sum_csr` over ``aux.ptr2``.

On a CUDA tensor :func:`live_partials` launches the hand-written Hopper
kernel ``csrc/live_partials.cu`` or raises; on a CPU tensor it runs
:func:`live_partials_plain`, the same function in plain PyTorch. Host aux
construction lives in
:func:`pyhgt_tpu_torch.sampling.sorted_batch.pallas_seg_aux`.
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
    most live rows any tile adds (0 = legacy: V = K).
    """

    loc: object
    blk: object
    ptr2: object
    live_key: Optional[object] = None
    w: int = 512
    v: int = 0
    # set by :meth:`to` once check_rows passed; the kernel takes no other aux
    rows_checked: bool = dataclasses.field(default=False, repr=False)

    @property
    def num_blocks(self) -> int:
        return self.blk.shape[0] - self.loc.shape[0] + 1

    def to(self, device) -> "PallasSegAux":
        """Tensors on ``device``: loc/blk int32 (the kernel reads them),
        ptr2/live_key int64 (index tensors). The host arrays are checked
        first (:func:`check_rows`)."""
        check_rows(self)

        def t(a, dt):
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
    """The kernel's precondition, on host (numpy) aux: within a tile ``loc``
    never decreases and stays in the window ``[0, W + V)``; the tiles' rows
    ``blk[t]*W + loc`` increase strictly from one tile to the next; the last
    row lies inside the ``[NB*W]`` output. Then each (tile, run) owns its
    row and no store leaves the buffer. Raises ValueError otherwise."""
    loc, blk = np.asarray(aux.loc), np.asarray(aux.blk)
    n_tiles, K = loc.shape
    if blk.shape[0] < n_tiles:
        raise ValueError("aux.blk shorter than the tile count")
    rows = blk[:n_tiles, None].astype(np.int64) * aux.w + loc
    if (loc.min() < 0 or loc.max() >= aux.w + (aux.v or K)
            or np.any(np.diff(loc, axis=1) < 0)
            or np.any(rows[1:, 0] <= rows[:-1, -1])
            or rows[-1, -1] >= aux.num_blocks * aux.w):
        raise ValueError("aux rows break the live_partials contract "
                         "(sorted ranks per tile, disjoint tiles, in bounds)")


def live_partials_plain(data: torch.Tensor, aux: PallasSegAux) -> torch.Tensor:
    """Plain PyTorch version of :func:`live_partials`: an f32
    ``index_add_`` of every row into ``blk[t]*W + loc[t, k]``."""
    n_tiles = aux.loc.shape[0]
    rows = aux.blk[:n_tiles].long()[:, None] * aux.w + aux.loc.long()
    out = torch.zeros((aux.num_blocks * aux.w, data.shape[1]),
                      dtype=torch.float32, device=data.device)
    return out.index_add_(0, rows.reshape(-1), data.float())


def _check(data: torch.Tensor, aux: PallasSegAux):
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
