"""ogbn-mag at a chosen scale, synthetically — the graph the port serves.

A copy of ``build`` of the repo's ``examples/ogbn_mag_scale_proxy.py``
(numpy only): a synthetic heterogeneous graph with the real ogbn-mag
schema, node and edge counts times ``scale``, temporal split and feature
width (reference ``ogbn-mag/README.md:16-24``):

  736,389 papers / 1,134,649 authors / 59,965 fields / 8,740 institutions
  writes 7.14M, cites 5.42M, has_topic 7.50M, affiliated_with 1.04M
  (+ auto reverses) = 42.2M directed edges; 349 classes; 128-dim paper
  features; year split train<2018 / valid=2018 / test=2019.

Scaling every count by the same factor keeps the per-type degrees, and so
the fan-outs a sampled subgraph sees, those of the full graph. Labels are
latent communities recoverable mostly from structure (chance = 1/349).
One seed gives the same arrays as the example's ``build``.
"""

from __future__ import annotations

import numpy as np

from pyhgt_tpu_torch.datasets.ogbn_mag import build_from_arrays

# real ogbn-mag counts (ogb.nodeproppred 'ogbn-mag' metadata)
REAL = dict(
    n_paper=736_389, n_author=1_134_649, n_field=59_965, n_inst=8_740,
    e_writes=7_145_660, e_cites=5_416_271, e_topic=7_505_078,
    e_aff=1_043_998, n_classes=349, feat_dim=128,
)


def build(scale: float, seed: int = 0):
    """The proxy graph at ``scale`` of the real counts (at least 8 of each),
    drawn from ``numpy.random.default_rng(seed)``."""
    r = np.random.default_rng(seed)
    s = lambda n: max(int(n * scale), 8)  # noqa: E731
    nP, nA = s(REAL["n_paper"]), s(REAL["n_author"])
    nF, nI = s(REAL["n_field"]), s(REAL["n_inst"])
    nC = min(REAL["n_classes"], max(nP // 64, 4))
    comm_p = r.integers(0, nC, size=nP)
    comm_a = r.integers(0, nC, size=nA)
    comm_f = r.integers(0, nC, size=nF)

    # community-biased endpoints: same community with prob q else uniform
    def endpoints(n_edges, comm_src, n_src, comm_tgt_of, n_tgt, q=0.8):
        src = r.integers(0, n_src, size=n_edges)
        same = r.random(n_edges) < q
        # a same-community target: rejection-free via per-community lists
        order = np.argsort(comm_tgt_of, kind="stable")
        sorted_comm = comm_tgt_of[order]
        starts = np.searchsorted(sorted_comm, np.arange(nC))
        ends = np.searchsorted(sorted_comm, np.arange(nC) + 1)
        c = comm_src[src]
        lo, hi = starts[c], np.maximum(ends[c], starts[c] + 1)
        pick = lo + (r.random(n_edges) * (hi - lo)).astype(np.int64)
        pick = order[np.minimum(pick, len(order) - 1)]
        tgt = np.where(same, pick, r.integers(0, n_tgt, size=n_edges))
        return src, tgt

    w_src, w_tgt = endpoints(s(REAL["e_writes"]), comm_a, nA, comm_p, nP)
    c_src, c_tgt = endpoints(s(REAL["e_cites"]), comm_p, nP, comm_p, nP)
    f_src, f_tgt = endpoints(s(REAL["e_topic"]), comm_p, nP, comm_f, nF)
    # real ogbn-mag has FEWER affiliation edges than authors (1.04M vs
    # 1.13M — not every author is affiliated); sample endpoints directly
    n_aff = s(REAL["e_aff"])
    a_src = r.integers(0, nA, size=n_aff)
    a_tgt = r.integers(0, nI, size=n_aff)

    years = r.integers(2010, 2020, size=nP)
    centroids = r.normal(size=(nC, REAL["feat_dim"])) * 0.3
    paper_x = (centroids[comm_p]
               + r.normal(size=(nP, REAL["feat_dim"]))).astype(np.float32)
    split = {
        "train": np.where(years < 2018)[0],
        "valid": np.where(years == 2018)[0],
        "test": np.where(years == 2019)[0],
    }
    return build_from_arrays(
        edge_index={
            ("author", "writes", "paper"): np.stack([w_src, w_tgt]),
            ("paper", "cites", "paper"): np.stack([c_src, c_tgt]),
            ("paper", "has_topic", "field_of_study"): np.stack([f_src, f_tgt]),
            ("author", "affiliated_with", "institution"): np.stack(
                [a_src, a_tgt]),
        },
        num_nodes={"paper": nP, "author": nA, "field_of_study": nF,
                   "institution": nI},
        paper_x=paper_x,
        years=years,
        y=comm_p,
        split=split,
    )
