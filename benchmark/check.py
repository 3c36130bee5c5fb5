"""The comparison that decides ``correct`` for a training cell.

The program's first steps (run in set-up through the window's own call
and feed) against the plain reference's on the same weights, batches and
dropout streams. Each number has its limit in the configuration file
(``limits``):

- ``batch_mismatch``: how often the program's batches (the sampled
  nodes, the padded edges with their ``dt``, the features, the masks, the
  labels) say something else than the reference's; exact, limit 0;
- ``loss_gap``: the largest gap between the program's loss and the
  reference's over the steps, over the reference's; ``first_loss_gap``
  the same for the first step alone (from the same weights, before the
  two sides' updates part);
- ``grad_norm_gap``: by the worst parameter, the gap between the norm of
  its first gradient as the optimizer got it (the program's from its
  AdamW state after one step, ``exp_avg / (1 - beta1)``) and the
  reference's, over the larger of the reference's norm of that parameter
  and of the median parameter;
- ``update_norm_gap``: the same for the norm of each parameter's change
  over the steps, leaving out the parameters whose first gradient in the
  reference is under a thousandth of the median parameter's (they move
  under AdamW by round-off alone);
- ``input_gap``: the widest gap between the program's input to the first
  layer in the first step (the input adapter's float32 products, tanh and
  dropout, before any edge stage rounds to bfloat16) and the reference's,
  over the reference's largest value: the number that a lower precision
  of the node products (TF32) moves where the bf16 edge stage blurs the
  others.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

# a parameter whose reference gradient is under this share of the median
# parameter's takes no part in update_norm_gap
STILL = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def _input_gap(prog, ref) -> float:
    """Per node type ``i``, the reference's rows of ``prog[i]`` against
    ``ref[i]`` (a padded ``[T, C, D]`` block or a list of ``[n_t, D]``)."""
    gap = scale = 0.0
    for p, r in zip(prog, ref):
        n = min(len(p), len(r))
        if n:
            gap = max(gap, float((p[:n] - r[:n]).abs().max()))
            scale = max(scale, float(r[:n].abs().max()))
    return gap / max(scale, 1e-30)


def numbers(prog: dict, ref: dict, batch_mismatch: int) -> Dict[str, float]:
    """The compared numbers; ``prog`` and ``ref`` hold ``losses``,
    ``grad_norms``, ``change_norms`` and ``inputs``."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grad_norms"])
    med = statistics.median(ref["grad_norms"][n] for n in names)
    moving = [n for n in names if ref["grad_norms"][n] >= STILL * med]
    out = dict(
        batch_mismatch=float(batch_mismatch),
        loss_gap=loss_gap,
        first_loss_gap=abs(prog["losses"][0] - ref["losses"][0])
        / max(abs(ref["losses"][0]), 1e-30),
        grad_norm_gap=_leaf_gap(prog["grad_norms"], ref["grad_norms"], names),
        update_norm_gap=_leaf_gap(prog["change_norms"], ref["change_norms"],
                                  moving),
        input_gap=_input_gap(prog["inputs"], ref["inputs"]),
    )
    if len(prog["losses"]) != len(ref["losses"]):
        out["loss_gap"] = math.inf
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """``(correct, {name: {"value", "limit"}})`` over the numbers that
    have a limit: every one finite and within it."""
    checks = {n: {"value": values[n], "limit": lim}
              for n, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
