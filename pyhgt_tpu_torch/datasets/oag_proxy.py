"""OAG at a chosen scale of the CS dataset, synthetically — the graph the
port trains the OAG tasks on and serves links from.

A copy of ``build`` of the repo's ``examples/oag_scale_proxy.py`` (numpy
only): a synthetic graph at representative OAG-CS magnitudes with the OAG
schema slice the paper-field, paper-venue and author-disambiguation tasks
exercise (``OAG/train_paper_field.py``):

- papers / authors / fields / venues / affiliations with
  ``AP_write_first`` / ``AP_write_other``, ``PP_cite``, ``PV_Journal``,
  ``PF_in_L2`` (the paper-field labels), ``PF_in_L1`` and author ``in``
  affiliation, plus their reverses;
- OAG concat feature columns (``feature_OAG``: node_emb ∥ emb ∥
  log-citation, ``pyHGT/utils.py:47-70``); papers have no ``node_emb``
  column and take the zeros path, as real OAG papers do;
- edge timestamps = the paper's year (2000-2019), for the temporal split
  train <= 2014 / valid 2015-16 / test >= 2017;
- multi-hot L2-field labels drawn biased to latent communities, so the KL
  objective has structure-carried signal.

Every count scales by the same factor, which keeps the per-type degrees,
and so a sampled subgraph's fan-outs, those of full scale. The graph has
no author names (author disambiguation's groups): a caller adds a
``name`` column to ``features["author"]``. One seed gives the same arrays
as the example's ``build``.
"""

from __future__ import annotations

import numpy as np

from pyhgt_tpu_torch.graph.csr import CSRGraph
from pyhgt_tpu_torch.graph.schema import GraphSchema, MetaRelation

# representative OAG-CS magnitudes (the reference publishes only GB sizes,
# README.md:43; these follow the WWW'20 paper's reported scale class)
SCALE_1 = dict(
    n_paper=544_000, n_author=510_000, n_field=45_000, n_venue=6_000,
    n_aff=9_000, n_l2=2_000,          # L2 label fields ⊂ fields
    ap_per_paper=3, cite_per_paper=5, pf_per_paper=3, pf1_per_paper=1,
    emb_dim=128,
)


def build(scale: float, seed: int = 0) -> CSRGraph:
    """The proxy graph at ``scale`` of ``SCALE_1`` (at least 16 of each
    node type), drawn from ``numpy.random.default_rng(seed)``."""
    r = np.random.default_rng(seed)
    s = lambda n: max(int(n * scale), 16)  # noqa: E731
    nP, nA = s(SCALE_1["n_paper"]), s(SCALE_1["n_author"])
    nF, nV = s(SCALE_1["n_field"]), s(SCALE_1["n_venue"])
    nI = s(SCALE_1["n_aff"])
    nL2 = min(s(SCALE_1["n_l2"]), nF - 1)  # keep >=1 non-L2 field so the
    # L1 rollup ids (nL2..nF) stay in range at tiny scale
    nC = max(min(nL2 // 8, 256), 4)   # latent communities

    comm_p = r.integers(0, nC, size=nP)
    comm_a = r.integers(0, nC, size=nA)
    # L2 fields are the first nL2 field ids; each belongs to a community
    comm_f2 = r.integers(0, nC, size=nL2)
    years = r.integers(2000, 2020, size=nP).astype(np.int64)

    def biased_pick(comm_src_rows, comm_tgt_of, n_tgt, q=0.85):
        """Per-row target biased to the source's community."""
        n = len(comm_src_rows)
        order = np.argsort(comm_tgt_of, kind="stable")
        sc = comm_tgt_of[order]
        starts = np.searchsorted(sc, np.arange(nC))
        ends = np.searchsorted(sc, np.arange(nC) + 1)
        lo, hi = starts[comm_src_rows], np.maximum(
            ends[comm_src_rows], starts[comm_src_rows] + 1)
        pick = order[np.minimum(
            lo + (r.random(n) * (hi - lo)).astype(np.int64), len(order) - 1)]
        return np.where(r.random(n) < q, pick,
                        r.integers(0, n_tgt, size=n))

    rep = lambda k: np.repeat(np.arange(nP), k)  # noqa: E731

    # authors write papers (first + other slots)
    p_ap = rep(SCALE_1["ap_per_paper"])
    a_ap = biased_pick(comm_p[p_ap], comm_a, nA)
    first = (np.arange(len(p_ap)) % SCALE_1["ap_per_paper"]) == 0
    # papers cite papers (older only, the reference's temporal semantics)
    p_c = rep(SCALE_1["cite_per_paper"])
    c_c = biased_pick(comm_p[p_c], comm_p, nP)
    keep = years[c_c] <= years[p_c]
    p_c, c_c = p_c[keep], c_c[keep]
    # paper -> L2 field labels (the signal), + coarse L1 rollups
    p_f = rep(SCALE_1["pf_per_paper"])
    f_f = biased_pick(comm_p[p_f], comm_f2, nL2, q=0.9)
    p_f1 = rep(SCALE_1["pf1_per_paper"])
    f_f1 = nL2 + (comm_p[p_f1] % max(nF - nL2, 1))
    # paper -> venue, author -> affiliation
    v_p = r.integers(0, nV, size=nP)
    i_a = r.integers(0, nI, size=nA)

    fwd = {
        ("author", "paper", "rev_AP_write_first"): (
            a_ap[first], p_ap[first], years[p_ap[first]]),
        ("author", "paper", "rev_AP_write_other"): (
            a_ap[~first], p_ap[~first], years[p_ap[~first]]),
        ("paper", "paper", "PP_cite"): (p_c, c_c, years[p_c]),
        ("field", "paper", "PF_in_L2"): (f_f, p_f, years[p_f]),
        ("field", "paper", "PF_in_L1"): (f_f1, p_f1, years[p_f1]),
        ("venue", "paper", "PV_Journal"): (v_p, np.arange(nP), years),
        ("affiliation", "author", "rev_in"): (
            i_a, np.arange(nA), np.full(nA, 2019)),
    }
    edges = {}
    metas = []
    for (tt, st, rel), (tgt, src, tm) in fwd.items():
        metas.append(MetaRelation(tt, st, rel))
        edges[(tt, st, rel)] = (tgt, src, tm)
        rrel = rel[len("rev_"):] if rel.startswith("rev_") else "rev_" + rel
        metas.append(MetaRelation(st, tt, rrel))
        edges[(st, tt, rrel)] = (src, tgt, tm)

    schema = GraphSchema(
        node_types=("paper", "author", "field", "venue", "affiliation"),
        metas=tuple(metas),
    )
    D = SCALE_1["emb_dim"]
    cent = r.normal(size=(nC, D)) * 0.25
    feats = {
        # papers: no node_emb column — the zeros path, like real OAG
        "paper": {
            "emb": (cent[comm_p] + r.normal(size=(nP, D))).astype(np.float32),
            "citation": r.pareto(1.5, size=nP).astype(np.float32) * 3,
        },
        "author": {
            "emb": (cent[comm_a] + r.normal(size=(nA, D))).astype(np.float32),
            "citation": r.pareto(1.5, size=nA).astype(np.float32) * 5,
            "node_emb": r.normal(size=(nA, 400)).astype(np.float32) * 0.05,
        },
        "field": {
            "emb": r.normal(size=(nF, D)).astype(np.float32) * 0.1,
            "citation": np.zeros(nF, np.float32),
            "node_emb": r.normal(size=(nF, 400)).astype(np.float32) * 0.05,
        },
        "venue": {
            "emb": r.normal(size=(nV, D)).astype(np.float32) * 0.1,
            "citation": np.zeros(nV, np.float32),
            "node_emb": r.normal(size=(nV, 400)).astype(np.float32) * 0.05,
        },
        "affiliation": {
            "emb": r.normal(size=(nI, D)).astype(np.float32) * 0.1,
            "citation": np.zeros(nI, np.float32),
        },
    }
    return CSRGraph.from_arrays(
        schema=schema,
        num_nodes={"paper": nP, "author": nA, "field": nF, "venue": nV,
                   "affiliation": nI},
        edges=edges,
        features=feats,
    )

