"""Candidate index for two-tower ``Matcher`` serving.

Counterpart of :mod:`pyhgt_tpu.tasks.matcher_index`. The reference caches
the left tower inside the module and never invalidates it
(``pyHGT/model.py:27-39``: "millions or even billions of nodes as
candidates"); here the cache is an explicit, versioned index on the
device:

- :meth:`build` embeds the candidate set once, in batches through the left
  tower;
- :meth:`score` multiplies query embeddings against the index (one
  ``[Q, D] x [D, N]`` product, ``torch.matmul``: the JAX package leaves it
  to XLA outside any kernel), with an optional top-k (``torch.topk``);
- :meth:`refresh` re-embeds after a parameter update: the invalidation the
  reference lacks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class MatcherIndex:
    """Precomputed left-tower embeddings of a fixed candidate set.

    ``matcher_apply(params, x) -> left embeddings`` takes a ``[n, D]``
    tensor; the embeddings stay on its output's device. ``params_version``
    counts the builds."""

    matcher_apply: Callable
    params_version: int = 0
    _emb: Optional[torch.Tensor] = None
    _cand_ids: Optional[np.ndarray] = None
    n_hid: Optional[int] = None

    def build(self, params, cand_features, cand_ids=None, batch: int = 8192):
        """Embed ``cand_features`` (a ``[n, D]`` tensor or array) through
        the left tower in batches."""
        cand = torch.as_tensor(cand_features)
        n = cand.shape[0]
        with torch.inference_mode():
            outs = [self.matcher_apply(params, cand[s : s + batch])
                    for s in range(0, n, batch)]
        self._emb = torch.cat(outs, dim=0)
        self.n_hid = int(self._emb.shape[-1])
        self._cand_ids = (
            np.asarray(cand_ids) if cand_ids is not None else np.arange(n)
        )
        self.params_version += 1
        return self

    def refresh(self, params, cand_features, **kw):
        """Re-embed after a parameter update (explicit invalidation)."""
        return self.build(params, cand_features, self._cand_ids, **kw)

    def score(self, query_emb, top_k: Optional[int] = None):
        """``[Q, n_cand]`` scaled dot scores on the index's device, or
        ``(values, candidate_ids)`` of the top-k per query (values a
        tensor, ids a host array; ties in no fixed order)."""
        if self._emb is None:
            raise RuntimeError("index not built; call build() first")
        q = torch.as_tensor(query_emb, device=self._emb.device)
        with torch.inference_mode():
            scores = torch.matmul(q, self._emb.T) / math.sqrt(self.n_hid)
            if top_k is None:
                return scores
            vals, idx = torch.topk(scores, top_k, dim=-1)
        return vals, self._cand_ids[idx.cpu().numpy()]
