"""ogbn-mag preprocessing → CSRGraph.

:func:`build_from_arrays` of :mod:`pyhgt_tpu.datasets.ogbn_mag`, copied
(numpy only). Parity with the reference ``ogbn-mag/preprocess_ogbn_mag.py``:

- every heterogeneous edge gets a forward + ``rev_`` twin, timestamped by
  the paper endpoint's year (``:29-42``);
- degree-augmented features: paper = ``[x ∥ log10(in_deg)]`` (``:69-70``);
  author/field = row-normalized mean of neighboring papers' features
  (``:71-86``); institution = mean of its authors' propagated features
  (``:88-99``);
- labels, split index arrays and boolean masks, years (``:103-123``).

Intentional deviations (documented per SURVEY.md §7): in-degree is clamped
to ≥0.01 before log10 (the reference emits -inf for isolated nodes), and
the missing ``Evaluator`` import bug (``:20``) is irrelevant here.

The JAX package's second entry point, ``preprocess_ogbn_mag`` (the
download through the ``ogb`` package), is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from pyhgt_tpu_torch.datasets.propagate import propagate_features
from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.graph.schema import GraphSchema, MetaRelation

EdgeDict = Dict[Tuple[str, str, str], np.ndarray]  # (src_type, rel, tgt_type) -> [2, E] (src, tgt)


def build_from_arrays(
    edge_index: EdgeDict,
    num_nodes: Dict[str, int],
    paper_x: np.ndarray,
    years: np.ndarray,
    y: np.ndarray,
    split: Dict[str, np.ndarray],
) -> CSRGraph:
    """Assemble the CSRGraph from raw hetero arrays (OGB layout)."""
    # forward + reverse metas in OGB iteration order (:29-42)
    metas = []
    per_meta: Dict[Tuple[str, str, str], Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for (s_type, rel, t_type), ei in edge_index.items():
        src, tgt = np.asarray(ei[0]), np.asarray(ei[1])
        if s_type == "paper":
            t = years[src]
        elif t_type == "paper":
            t = years[tgt]
        else:
            t = np.zeros(len(src), dtype=np.int64)
        metas.append(MetaRelation(t_type, s_type, rel))
        per_meta[(t_type, s_type, rel)] = (tgt, src, t)
        rrel = "rev_" + rel
        metas.append(MetaRelation(s_type, t_type, rrel))
        per_meta[(s_type, t_type, rrel)] = (src, tgt, t)

    node_types = tuple(num_nodes.keys())
    schema = GraphSchema(node_types=node_types, metas=tuple(metas))

    # in-degree per node over all relations (:46-64)
    deg = {t: np.zeros(num_nodes[t]) for t in node_types}
    for (tt, _st, _rel), (tgt, _src, _t) in per_meta.items():
        np.add.at(deg[tt], tgt, 1.0)

    def logdeg(t):
        return np.log10(np.maximum(deg[t], 1e-2)).reshape(-1, 1).astype(np.float32)

    feats: Dict[str, Dict[str, np.ndarray]] = {}
    paper_x = np.asarray(paper_x, dtype=np.float32)
    feats["paper"] = {"emb": np.concatenate([paper_x, logdeg("paper")], axis=1)}
    # author/field: normalized paper-mean (:71-86)
    for t in node_types:
        if t in ("paper", "institution"):
            continue
        tgts, srcs = [], []
        for (tt, st, _rel), (tgt, src, _tm) in per_meta.items():
            if tt == t and st == "paper":
                tgts.append(tgt)
                srcs.append(src)
        if not tgts:
            continue
        prop = propagate_features(
            (np.concatenate(tgts), np.concatenate(srcs)), paper_x, num_nodes[t]
        )
        feats[t] = {"emb": np.concatenate([prop, logdeg(t)], axis=1)}
    # institution: author-mean of the propagated author features (:88-99)
    if "institution" in node_types and "author" in feats:
        author_cv = feats["author"]["emb"][:, :-1]
        tgts, srcs = [], []
        for (tt, st, _rel), (tgt, src, _tm) in per_meta.items():
            if tt == "institution" and st == "author":
                tgts.append(tgt)
                srcs.append(src)
        if tgts:
            prop = propagate_features(
                (np.concatenate(tgts), np.concatenate(srcs)),
                author_cv, num_nodes["institution"],
            )
            feats["institution"] = {
                "emb": np.concatenate([prop, logdeg("institution")], axis=1)
            }

    y = np.asarray(y).reshape(-1)
    masks = {}
    for name in ("train", "valid", "test"):
        m = np.zeros(num_nodes["paper"], dtype=bool)
        m[np.asarray(split[name]).reshape(-1)] = True
        masks[f"{name}_mask"] = m

    return CSRGraph.from_arrays(
        schema=schema,
        num_nodes=dict(num_nodes),
        edges={k: v for k, v in per_meta.items()},
        features=feats,
        aux=dict(
            y=y,
            years=np.asarray(years).reshape(-1),
            **masks,
            train_paper=np.asarray(split["train"]).reshape(-1),
            valid_paper=np.asarray(split["valid"]).reshape(-1),
            test_paper=np.asarray(split["test"]).reshape(-1),
        ),
    )
