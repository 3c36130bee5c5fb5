"""HGSampling — type-balanced, degree²-weighted layer-wise subgraph sampling.

A copy of :mod:`pyhgt_tpu.sampling.hgsampler` (numpy only): under the same
``numpy.random.Generator`` state it draws the same subgraph.

Semantics parity with the reference ``sample_subgraph``
(``pyHGT/data.py:87-210``):

- a per-source-type *budget* accumulates ``1/len(sampled_neighbors)`` scores
  when a sampled node touches a neighbor (``:112-130``);
- each of ``depth`` rounds draws ``width`` nodes per type without replacement
  with probability proportional to score² (``:147-172``);
- a temporal filter drops sources newer than ``time_max`` (``:127``; the
  ogbn-mag copy omits the filter — pass ``time_max=None`` for that mode);
- untimed edges inherit the target's timestamp (``:124-126``);
- the induced edge list is reconstructed by membership against the full
  graph (``:191-209``) and label-leakage edges can be masked afterwards
  (library feature here; per-script copy-paste in the reference,
  ``OAG/train_paper_field.py:111-122``).

Runs on the frozen CSR graph with numpy; a drop-in C++ core (same budget
semantics) lives in :mod:`pyhgt_tpu_torch.sampling.native` for the hot
path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pyhgt_tpu_torch.graph.container import NO_TIME
from pyhgt_tpu_torch.graph.csr import CSRGraph, MetaKey


@dataclasses.dataclass
class RawSample:
    """Ragged (pre-padding) sampled subgraph.

    ``node_ids[type]`` are original node ids in sampling order (seeds first,
    so seed k of type t has local index k — the contract the leakage mask and
    the task heads rely on, cf. ``OAG/train_paper_field.py:111-138``).
    ``edges[meta] = (tgt_local, src_local)`` index into those orders.
    """

    node_ids: Dict[str, np.ndarray]
    node_time: Dict[str, np.ndarray]
    edges: Dict[MetaKey, Tuple[np.ndarray, np.ndarray]]
    seed_counts: Dict[str, int]


class HGSampler:
    """Reusable sampler bound to one CSRGraph."""

    def __init__(
        self,
        graph: CSRGraph,
        depth: int = 6,
        width: int = 128,
        time_max: Optional[int] = None,
    ) -> None:
        self.graph = graph
        self.schema = graph.schema
        self.depth = depth
        self.width = width
        self.time_max = time_max
        # metas grouped by target type, precomputed once
        self._expand_metas: Dict[str, List[MetaKey]] = {
            t: [m.as_tuple() for m in graph.metas_targeting(t)]
            for t in self.schema.node_types
        }

    # -----------------------------------------------------------------------
    def sample_raw(
        self,
        seeds: Dict[str, np.ndarray],
        rng: Optional[np.random.Generator] = None,
        time_max: Optional[int] = ...,  # Ellipsis sentinel: sampler default
    ) -> RawSample:
        """Sample a subgraph. ``seeds[type]`` is an ``[n, 2]`` array of
        (node_id, time) rows, mirroring the reference ``inp`` format."""
        rng = rng or np.random.default_rng()
        if time_max is ...:  # Ellipsis = "use the sampler default"
            time_max = self.time_max
        width = self.width
        graph = self.graph

        # layer_data[type]: {node_id: (ser, time)}
        layer: Dict[str, Dict[int, Tuple[int, int]]] = {
            t: {} for t in self.schema.node_types
        }
        # budget[type]: {node_id: [score, time]}
        budget: Dict[str, Dict[int, List[float]]] = {
            t: {} for t in self.schema.node_types
        }

        def add_budget(node_type: str, node_id: int, node_time: int) -> None:
            for meta in self._expand_metas[node_type]:
                adj = graph.adj[meta]
                if node_id + 1 >= adj.indptr.shape[0]:
                    continue
                srcs, times = adj.row(node_id)
                n = srcs.shape[0]
                if n == 0:
                    continue
                if n > width:
                    pick = rng.choice(n, width, replace=False)
                    srcs, times = srcs[pick], times[pick]
                    n = width
                inv = 1.0 / n
                src_type = meta[1]
                seen = layer[src_type]
                b = budget[src_type]
                for sid, st_time in zip(srcs.tolist(), times.tolist()):
                    if st_time == NO_TIME:
                        st_time = node_time
                    if time_max is not None and st_time > time_max:
                        continue
                    if sid in seen:
                        continue
                    cell = b.get(sid)
                    if cell is None:
                        b[sid] = [inv, st_time]
                    else:
                        cell[0] += inv
                        cell[1] = st_time

        # seed insertion first, then budget expansion (pyHGT/data.py:135-141)
        for t, arr in seeds.items():
            arr = np.asarray(arr)
            ld = layer[t]
            for nid, ntime in arr:
                nid = int(nid)
                if nid not in ld:
                    ld[nid] = (len(ld), int(ntime))
        for t, arr in seeds.items():
            arr = np.asarray(arr)
            for nid, ntime in arr:
                add_budget(t, int(nid), int(ntime))

        # depth rounds of score²-weighted draws (pyHGT/data.py:147-172).
        # The round's type list is snapshotted up front, like the reference's
        # `sts = list(budget.keys())`: a type first reached mid-round is only
        # drawn from starting the next round.
        for _ in range(self.depth):
            sts = [t for t in self.schema.node_types if budget[t]]
            for src_type in sts:
                b = budget[src_type]
                if not b:
                    continue
                keys = np.fromiter(b.keys(), dtype=np.int64, count=len(b))
                if width >= len(keys):
                    chosen = keys
                else:
                    score = np.fromiter(
                        (cell[0] for cell in b.values()),
                        dtype=np.float64,
                        count=len(b),
                    )
                    score = score * score
                    score /= score.sum()
                    chosen = keys[
                        rng.choice(len(keys), width, replace=False, p=score)
                    ]
                ld = layer[src_type]
                for k in chosen.tolist():
                    ld[k] = (len(ld), int(b[k][1]))
                for k in chosen.tolist():
                    add_budget(src_type, k, int(b[k][1]))
                    del b[k]

        # induced-subgraph reconstruction (pyHGT/data.py:191-209)
        node_ids = {
            t: np.fromiter(d.keys(), dtype=np.int64, count=len(d))
            for t, d in layer.items()
        }
        node_time = {
            t: np.array([v[1] for v in d.values()], dtype=np.int64)
            for t, d in layer.items()
        }
        edges: Dict[MetaKey, Tuple[np.ndarray, np.ndarray]] = {}
        for meta in (m.as_tuple() for m in self.schema.metas):
            tt, st, _ = meta
            tld, sld = layer[tt], layer[st]
            if not tld or not sld:
                continue
            adj = graph.adj[meta]
            # src-side membership: original id -> local ser
            src_lut = sld
            t_out: List[int] = []
            s_out: List[int] = []
            for tid, (tser, _tm) in tld.items():
                if tid + 1 >= adj.indptr.shape[0]:
                    continue
                srcs, _ = adj.row(tid)
                for sid in srcs.tolist():
                    cell = src_lut.get(sid)
                    if cell is not None:
                        t_out.append(tser)
                        s_out.append(cell[0])
            if t_out:
                edges[meta] = (
                    np.asarray(t_out, dtype=np.int32),
                    np.asarray(s_out, dtype=np.int32),
                )
        seed_counts = {t: len(np.asarray(a)) for t, a in seeds.items()}
        return RawSample(
            node_ids=node_ids,
            node_time=node_time,
            edges=edges,
            seed_counts=seed_counts,
        )


def mask_seed_edges(
    sample: RawSample,
    meta: MetaKey,
    num_seeds: int,
    seed_side: str,
) -> None:
    """Remove edges of ``meta`` whose seed-side endpoint is one of the first
    ``num_seeds`` nodes — the label-leakage mask of
    ``OAG/train_paper_field.py:111-122`` as a library feature.

    ``seed_side`` is ``'tgt'`` or ``'src'``: which endpoint holds the seeds.
    Call twice (relation + its ``rev_`` twin) like the reference does.
    """
    if meta not in sample.edges:
        return
    tgt, src = sample.edges[meta]
    if seed_side == "tgt":
        keep = tgt >= num_seeds
    elif seed_side == "src":
        keep = src >= num_seeds
    else:
        raise ValueError(f"seed_side must be 'tgt' or 'src', got {seed_side!r}")
    sample.edges[meta] = (tgt[keep], src[keep])
