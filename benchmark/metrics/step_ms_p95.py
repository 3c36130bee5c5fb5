"""Epoch loop: the 95th percentile of the intervals between consecutive
step ends on the card's timeline (CUDA events), over the window's steps."""

import numpy as np


def read(ctx):
    ms = ctx["window"]["step_ms"]
    return float(np.percentile(ms, 95)) if len(ms) >= 20 else None
