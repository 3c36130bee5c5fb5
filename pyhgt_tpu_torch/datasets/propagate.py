"""Offline feature propagation to featureless node types.

A copy of :mod:`pyhgt_tpu.datasets.propagate` (numpy + scipy).

Parity with the reference preprocessors: row-normalized sparse adjacency
averaging (``normalize`` at ``pyHGT/utils.py:23-30``; used
to propagate paper embeddings to venue/field/author and onwards to
affiliation, ``OAG/preprocess_OAG.py:341-393``,
``ogbn-mag/preprocess_ogbn_mag.py:71-99``). Host-side scipy — this is a
one-shot offline step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def normalize_rows(mx: sp.spmatrix) -> sp.spmatrix:
    """Row-normalize a sparse matrix (``utils.py:23-30``: D^-1 A)."""
    rowsum = np.asarray(mx.sum(1)).flatten()
    r_inv = np.divide(1.0, rowsum, out=np.zeros_like(rowsum, dtype=float),
                      where=rowsum != 0)
    return sp.diags(r_inv) @ mx


def propagate_features(
    edges: Tuple[np.ndarray, np.ndarray],
    src_features: np.ndarray,
    n_tgt: int,
    time_filter: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Mean of source features over each target's neighbors.

    ``edges = (tgt_ids, src_ids)``; optional boolean ``time_filter`` keeps
    only training-period edges (the reference propagates with
    ``<= test_time_bar`` edges only, ``preprocess_OAG.py:360``).
    """
    tgt, src = edges
    if time_filter is not None:
        tgt, src = tgt[time_filter], src[time_filter]
    n_src = src_features.shape[0]
    adj = sp.coo_matrix(
        (np.ones(len(tgt)), (tgt, src)), shape=(n_tgt, n_src)
    ).tocsr()
    return np.asarray(normalize_rows(adj) @ src_features, dtype=src_features.dtype)
