"""The bytes a segment kernel must move, from its tensors' shapes: each
input read once, each output written once (``chip_smoke.py``'s
``partials_bytes``, the bound of the port's kernel table). Over the
card's memory rate they give the launch's least time."""

from __future__ import annotations


def partials_bytes(rows: int, cols: int, elem_size: int, aux,
                   n_tensors: int = 1) -> int:
    """A ``live_partials`` walk over ``n_tensors`` ``[rows, cols]``
    inputs of ``elem_size`` bytes on ``aux`` (``loc [tiles, K]``, the
    output ``num_blocks x w`` f32 rows): inputs, ``loc`` and ``blk`` read
    once, each output written once."""
    n_tiles = aux.loc.shape[0]
    out_rows = aux.num_blocks * aux.w
    return (n_tensors * rows * cols * elem_size
            + aux.loc.numel() * 4 + n_tiles * 4
            + n_tensors * out_rows * cols * 4)


def softmax_partials_bytes(rows: int, heads: int, aux) -> int:
    """``segment_softmax_partials`` over f32 logits ``[rows, heads]``: the
    logits, ``loc`` and ``blk`` read once, the max and sum rows written
    once."""
    n_tiles = aux.loc.shape[0]
    out_rows = aux.num_blocks * aux.w
    return (rows * heads * 4 + aux.loc.numel() * 4 + n_tiles * 4
            + 2 * out_rows * heads * 4)
