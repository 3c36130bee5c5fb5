"""Feature extractors — assemble per-type input matrices at sampling time.

A copy of :mod:`pyhgt_tpu.datasets.features` (numpy only). Parity:

- ``feature_OAG`` (reference ``pyHGT/utils.py:47-70``): concat
  ``[node_emb (400, zeros if absent) ∥ emb ∥ log10(citation + 0.01)]``
  giving ``in_dim = emb_dim + 401`` (the reference model's
  ``in_dim = len(emb) + 401``, ``OAG/train_paper_field.py:190``): 529 for
  OAG's 128-wide ``emb``, which only the model's input ``Linear`` reads.
- ``feature_MAG`` (``ogbn-mag/pyHGT/utils.py:93-106``): plain row gather.

Both match the ``feature_fn(graph, type, ids) -> [n, D]`` contract of
:func:`pyhgt_tpu_torch.tasks.base.gather_features`.
"""

from __future__ import annotations

import numpy as np

from pyhgt_tpu_torch.graph.csr import CSRGraph

OAG_NODE_EMB_DIM = 400  # pretrained vfi vectors (utils.py:55-61)


def feature_mag(graph: CSRGraph, node_type: str, ids: np.ndarray) -> np.ndarray:
    """Row gather of the 'emb' column (``feature_MAG``)."""
    return np.asarray(graph.features[node_type]["emb"])[ids].astype(np.float32)


def feature_oag(graph: CSRGraph, node_type: str, ids: np.ndarray) -> np.ndarray:
    """OAG concat features (``feature_OAG``, ``utils.py:47-70``)."""
    cols = graph.features[node_type]
    n = len(ids)
    if "node_emb" in cols:
        node_emb = np.asarray(cols["node_emb"])[ids].astype(np.float32)
    else:
        node_emb = np.zeros((n, OAG_NODE_EMB_DIM), dtype=np.float32)
    emb = np.asarray(cols["emb"])[ids].astype(np.float32)
    cit = np.asarray(cols["citation"])[ids].astype(np.float64)
    cit = np.log10(cit + 0.01).astype(np.float32)[:, None]
    return np.concatenate([node_emb, emb, cit], axis=1)


def oag_in_dim(graph: CSRGraph, emb_type: str = "paper") -> int:
    """emb_dim + 401 (``OAG/train_paper_field.py:190``)."""
    return int(np.asarray(graph.features[emb_type]["emb"]).shape[1]) + \
        OAG_NODE_EMB_DIM + 1


def texts_oag(
    graph: CSRGraph, sample, text_type: str = "paper",
    text_key: str = "title",
) -> np.ndarray:
    """Sampled papers' titles — the reference's ``texts`` output of
    ``feature_OAG`` (``pyHGT/utils.py:68-69``), kept apart from the numeric
    feature matrix because titles never reach the device.

    ``sample`` is a :class:`~pyhgt_tpu_torch.sampling.hgsampler.RawSample`;
    returns a [n_sampled_papers] unicode array in sample order (empty if
    the graph carries no title column).
    """
    cols = graph.features.get(text_type) or {}
    if text_key not in cols:
        return np.array([], dtype=np.str_)
    ids = sample.node_ids.get(text_type)
    if ids is None or len(ids) == 0:
        return np.array([], dtype=np.str_)
    return np.asarray(cols[text_key])[np.asarray(ids)].astype(np.str_)
