"""Relative Temporal Encoding — the frozen sinusoidal table.

Counterpart of :mod:`pyhgt_tpu.ops.rte`. Parity with the reference
``RelTemporalEncoding`` (``pyHGT/conv.py:283-299``): a ``max_len``-row
sinusoidal embedding scaled by ``1/sqrt(n_hid)``, deliberately
non-trainable, followed by a trainable linear applied by the conv layer.
Built once in numpy (float64, rounded to float32) so both packages hold the
same bits.
"""

from __future__ import annotations

import numpy as np

RTE_MAX_LEN = 240  # pyHGT/conv.py:287


def rte_sin_table(n_hid: int, max_len: int = RTE_MAX_LEN) -> np.ndarray:
    """[max_len, n_hid] sinusoidal table, scaled by 1/sqrt(n_hid).

    Row t: even columns sin(t / 10000^(2i/n_hid)), odd columns cos(...),
    matching ``conv.py:289-293``.
    """
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(
        np.arange(0, n_hid, 2, dtype=np.float64) * -(np.log(10000.0) / n_hid)
    )
    table = np.zeros((max_len, n_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(position * div)
    table[:, 1::2] = np.cos(position * div[: (n_hid - n_hid // 2)])
    return (table / np.sqrt(n_hid)).astype(np.float32)
