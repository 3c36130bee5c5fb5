"""Host counters that a CUDA graph's replay advances by what its capture
counted (:class:`~pyhgt_tpu_torch.train.graph_step.GraphedStep`): the
hand kernels' launches and DenseHGT's FFN calls. Each owner registers its
object and the names of its integer fields when its module is imported."""

from __future__ import annotations

# (object, field names), in the order of registration
REPLAYED: list = []


def register(obj, *fields: str):
    """Add ``obj``'s ``fields`` to the counters a replay advances; returns
    ``obj``."""
    REPLAYED.append((obj, fields))
    return obj


def snapshot() -> dict:
    """Every registered counter's value, by ``(object, field)``."""
    return {(obj, c): getattr(obj, c) for obj, fields in REPLAYED
            for c in fields}
