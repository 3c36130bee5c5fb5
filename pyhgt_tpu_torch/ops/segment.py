"""Masked segment primitives over flat edge arrays.

Counterpart of :mod:`pyhgt_tpu.ops.segment`: the reference's per-target
segment softmax (``torch_geometric.utils.softmax``, ``pyHGT/conv.py:108``)
and the scatter-add hidden in PyG's ``MessagePassing(aggr='add')``
(``conv.py:13``), in plain PyTorch (``index_add_`` and
``scatter_reduce(..., "amax")``). The JAX package lowers them to XLA
scatters, not Pallas kernels; they are the segment edge path's and the
baseline convs' reductions.

Every function takes a ``mask``, since batches are padded to fixed shapes:
a masked row adds 0 to a sum and ``NEG`` to a maximum. On a CUDA tensor
``index_add_`` adds f32 rows in no fixed order, so two calls may differ in
the last bits.

Rows are gathered per edge by ``index_select``, never by indexing
(``t[idx]``): the backward of ``index_select`` is an ``index_add_``, that
of indexing an accumulating ``index_put_``, which on a CUDA tensor sorts
the indices and sums each run of equal ones serially. A padded batch
points all its masked edges at node 0 (over half of an OAG batch's edge
slots), and that run made ``index_put_`` 87-95% of a baseline conv's
train step on an NVIDIA H100 (``scripts/conv_step_profile.py``).
"""

from __future__ import annotations

import torch

# Large-negative sentinel: avoids -inf (exp(-inf - -inf) = nan on empty
# segments) while still vanishing under exp after max-subtraction.
NEG = -1e30


def _masked(data, mask, fill):
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))
    return torch.where(m, data, torch.full_like(data, fill))


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    """Masked sum of ``data`` rows into ``num_segments`` buckets."""
    data = _masked(data, mask, 0.0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data, segment_ids, num_segments: int, mask=None):
    """Masked max per segment: a segment whose rows are all masked gives
    ``NEG``, one with no row at all ``-inf`` (as ``jax.ops.segment_max``)."""
    data = _masked(data, mask, NEG)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                              include_self=False)


def segment_softmax(scores, segment_ids, num_segments: int, mask=None):
    """Numerically stable softmax over each segment (the semantics of
    ``torch_geometric.utils.softmax``): subtract the segment's max,
    exponentiate, divide by the segment's sum. Masked rows get weight 0; a
    segment with no valid row gets all-zero weights (its denominator is
    replaced by 1), and an empty one's max is ``NEG``, never ``-inf``.

    ``scores``: ``[E]`` or ``[E, H]``; ``segment_ids``: ``[E]``; returns
    the shape of ``scores``. The max is held constant under autograd: the
    weights do not depend on it, so its gradient is zero."""
    scores = _masked(scores, mask, NEG)
    seg_max = segment_max(scores.detach(), segment_ids, num_segments)
    seg_max = torch.clamp(seg_max, min=NEG)  # empty segments: -inf -> NEG
    ids = segment_ids.long()
    ex = torch.exp(scores - seg_max.index_select(0, ids))
    ex = _masked(ex, mask, 0.0)
    den = segment_sum(ex, ids, num_segments)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return ex / den.index_select(0, ids)
