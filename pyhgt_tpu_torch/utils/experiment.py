"""Experiment helpers (counterpart of :mod:`pyhgt_tpu.utils.experiment`;
parity: the reference's ``ogbn-mag/pyHGT/utils.py``)."""

from __future__ import annotations

import numpy as np
from torch import nn


def get_n_params(model: nn.Module) -> int:
    """Total parameter count of a model (``utils.py:8-14``)."""
    return int(sum(p.numel() for p in model.parameters()))


def args_print(args, file=None) -> None:
    """Pretty-print a config namespace/dataclass/dict as an aligned table
    (``utils.py:16-23`` uses texttable; plain formatting here)."""
    items = vars(args) if not isinstance(args, dict) else args
    width = max((len(str(k)) for k in items), default=0)
    print("\n".join(f"  {k:<{width}}  {v}" for k, v in items.items()),
          file=file)


def randint() -> int:
    """Fresh 32-bit seed — per-sampling-job RNG decorrelation
    (``pyHGT/utils.py:42-43``)."""
    return int(np.random.randint(0, 2**31 - 1))


def plot_history(history, path: str) -> str:
    """Loss/metric curves PNG (the reference's ``--plot``,
    ``train_ogbn_mag.py:29-30,178-189``).

    One panel per measure — loss and the validation metric live on
    different scales, and a dual-axis chart misleads; stacked panels
    share the epoch axis instead. Single series per panel (the title
    names it, no legend); Okabe-Ito hues (colorblind-safe), thin 2px
    lines, recessive grid.

    matplotlib is imported here, not with the module: without it this
    raises ``ImportError``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = [h.get("epoch", i) for i, h in enumerate(history)]
    metric_key = next(
        (k for k in ("valid_acc", "valid_ndcg") if history and k in history[0]),
        None,
    )
    n_panels = 2 if metric_key else 1
    fig, axes = plt.subplots(
        n_panels, 1, figsize=(6, 2.6 * n_panels), sharex=True, squeeze=False
    )
    panels = [("train loss", [h["loss"] for h in history], "#0072B2")]
    if metric_key:
        panels.append(
            (metric_key.replace("_", " "),
             [h[metric_key] for h in history], "#D55E00")
        )
    for ax, (title, ys, color) in zip(axes[:, 0], panels):
        # markers keep 1-epoch histories visible (a bare line needs >=2 pts)
        ax.plot(epochs, ys, color=color, linewidth=2, marker="o",
                markersize=4)
        ax.set_title(title, fontsize=10, loc="left", color="#333333")
        ax.grid(True, color="#e6e6e6", linewidth=0.6)
        ax.tick_params(labelsize=8, colors="#555555")
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color("#cccccc")
    axes[-1, 0].set_xlabel("epoch", fontsize=9, color="#555555")
    fig.tight_layout()
    fig.savefig(path, dpi=144)
    plt.close(fig)
    return path
