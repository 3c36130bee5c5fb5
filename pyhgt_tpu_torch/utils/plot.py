"""Optional training-curve plots (counterpart of :mod:`pyhgt_tpu.utils.plot`;
parity with the reference's seaborn loss/accuracy figures,
``ogbn-mag/train_ogbn_mag.py:203-215``). Gated on matplotlib; the primary
record is the jsonl metrics stream (:mod:`pyhgt_tpu_torch.train.log`)."""

from __future__ import annotations

from typing import Dict, List, Optional


def plot_history(history: List[Dict], path: str, keys=("loss",)) -> Optional[str]:
    """Write a PNG of per-epoch curves; returns the path or None if
    matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(7, 4))
    xs = [h.get("epoch", i) for i, h in enumerate(history)]
    for k in keys:
        ys = [h.get(k) for h in history]
        if any(y is not None for y in ys):
            ax.plot(xs, ys, label=k)
    ax.set_xlabel("epoch")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
