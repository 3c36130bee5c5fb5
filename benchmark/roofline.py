"""A kernel's share of its roofline in the traced steps: the bytes its
launches must move (``benchmark.kernel_bytes``, counted per batch on the
host) at the card's memory rate, over the device time of the kernels
that implement it, found by name in the trace."""

from __future__ import annotations

import re

from benchmark.peaks import HBM_BYTES_PER_S

# the walks' template is walk_kernel<T, kind, outputs>: the pair (and the
# slab, off this path) has two outputs, live_partials one
_WALK = re.compile(r"walk_kernel<[^>]*?(\d+)\s*\)?\s*>")


def is_pair_walk(name: str) -> bool:
    m = _WALK.search(name)
    return bool(m) and m.group(1) == "2"


def is_softmax(name: str) -> bool:
    return "softmax_partials_kernel" in name


def share(trace: dict, kernel: str, match) -> float | None:
    """Percent of the roofline; None where the trace has no such kernel,
    or the program's launch count differs from the batches' count."""
    if not trace.get("counts"):
        return None
    want = sum(c[f"{kernel}_launches"] for c in trace["counts"])
    nbytes = sum(c[f"{kernel}_bytes"] or 0 for c in trace["counts"])
    seconds = sum(s for n, s in trace["kernels"] if match(n))
    if not want or trace["launches"][kernel] != want or seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
