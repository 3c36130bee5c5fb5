"""Static graph schema — the contract between the host layout and the model.

A copy of :mod:`pyhgt_tpu.graph.schema` (pure Python, no framework): the
ordered node types, the ordered meta-relations (target_type, source_type,
relation), the relation-name -> id mapping, and the padded batch layout
(per-type node capacity, per-meta-relation edge capacities). Two batches
with the same ``GraphSchema`` + ``PadSpec`` have identical array shapes.

Relation-id semantics mirror the reference exactly so weights are
interchangeable in parity tests: the reference builds
``edge_dict = {meta[i][2]: i}`` (later duplicates of a relation *name* win)
and appends ``edge_dict['self'] = len(edge_dict)`` (``pyHGT/data.py:237-238``),
while the model over-allocates ``num_relations = len(meta)+1`` banks
(``OAG/train_paper_field.py:192`` — acknowledged quirk, TODO at
``pyHGT/conv.py:41-43``). We keep both numbers: ``rel_id`` uses the
reference mapping; ``num_relations`` is the parameter-bank size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

SELF_REL = "self"


@dataclasses.dataclass(frozen=True)
class MetaRelation:
    """One (target_type, source_type, relation) triple."""

    tgt_type: str
    src_type: str
    rel: str

    def as_tuple(self) -> Tuple[str, str, str]:
        return (self.tgt_type, self.src_type, self.rel)


@dataclasses.dataclass(frozen=True)
class EdgeBlockSpec:
    """Static placement of one meta-relation's edges in the flat edge arrays."""

    meta: MetaRelation
    rel_id: int        # index into relation parameter banks
    tgt_type_id: int
    src_type_id: int
    start: int         # offset into the flat edge arrays
    cap: int           # padded capacity of this block

    @property
    def stop(self) -> int:
        return self.start + self.cap


@dataclasses.dataclass(frozen=True)
class GraphSchema:
    """Ordered types + meta-relations of a heterogeneous graph."""

    node_types: Tuple[str, ...]
    metas: Tuple[MetaRelation, ...]           # excludes 'self'

    def __post_init__(self):
        object.__setattr__(self, "_type_id", {t: i for i, t in enumerate(self.node_types)})
        # reference mapping: name -> last index among metas, then 'self'
        rel_id: Dict[str, int] = {}
        for i, m in enumerate(self.metas):
            rel_id[m.rel] = i
        rel_id[SELF_REL] = len(rel_id)
        object.__setattr__(self, "_rel_id", rel_id)

    # -- identity ----------------------------------------------------------
    @property
    def num_types(self) -> int:
        return len(self.node_types)

    @property
    def num_relations(self) -> int:
        """Parameter-bank size: len(metas) + 1, matching the reference's
        ``num_relations = len(graph.get_meta_graph()) + 1``."""
        return len(self.metas) + 1

    @property
    def self_rel_id(self) -> int:
        return self._rel_id[SELF_REL]

    def type_id(self, t: str) -> int:
        return self._type_id[t]

    def rel_id(self, rel: str) -> int:
        return self._rel_id[rel]

    @property
    def relation_names(self) -> List[str]:
        return list(self._rel_id.keys())

    @classmethod
    def from_graph(cls, graph) -> "GraphSchema":
        metas = tuple(
            MetaRelation(*m) for m in graph.get_meta_graph() if m[2] != SELF_REL
        )
        return cls(node_types=tuple(graph.get_types()), metas=metas)

    # -- batch layout --------------------------------------------------------
    def build_blocks(self, pad: "PadSpec") -> Tuple[Tuple[EdgeBlockSpec, ...], int]:
        """Lay out flat edge arrays: one block per meta-relation, then one
        'self' block per node type (cap = node capacity). Returns (blocks,
        total_edge_capacity)."""
        blocks: List[EdgeBlockSpec] = []
        off = 0
        for m in self.metas:
            cap = pad.edge_cap(m)
            blocks.append(
                EdgeBlockSpec(
                    meta=m,
                    rel_id=self.rel_id(m.rel),
                    tgt_type_id=self.type_id(m.tgt_type),
                    src_type_id=self.type_id(m.src_type),
                    start=off,
                    cap=cap,
                )
            )
            off += cap
        for t in self.node_types:
            m = MetaRelation(t, t, SELF_REL)
            blocks.append(
                EdgeBlockSpec(
                    meta=m,
                    rel_id=self.self_rel_id,
                    tgt_type_id=self.type_id(t),
                    src_type_id=self.type_id(t),
                    start=off,
                    cap=pad.node_cap,
                )
            )
            off += pad.node_cap
        return tuple(blocks), off


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Padded capacities for a batch. ``node_cap`` is the per-type node
    capacity (uniform, so nodes pack to a dense ``[T, C, D]`` tensor);
    ``edge_caps`` maps a meta triple to its edge capacity, with
    ``default_edge_cap`` as fallback. A calibrated spec also notes what
    sized its node cap (not compared): ``node_calibrated``, the cap the
    draws asked for, and ``node_bound``, HGSampling's own bound that caps
    it (``None`` where the task's seeds have none)."""

    node_cap: int
    default_edge_cap: int
    edge_caps: Tuple[Tuple[Tuple[str, str, str], int], ...] = ()
    node_calibrated: Optional[int] = dataclasses.field(default=None,
                                                       compare=False)
    node_bound: Optional[int] = dataclasses.field(default=None,
                                                  compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_caps", dict(self.edge_caps))

    def edge_cap(self, meta: MetaRelation) -> int:
        return self._caps.get(meta.as_tuple(), self.default_edge_cap)

    @classmethod
    def for_sampler(
        cls,
        num_seeds: int,
        depth: int,
        width: int,
        schema: GraphSchema,
        edge_caps: Optional[Dict[Tuple[str, str, str], int]] = None,
        default_edge_cap: Optional[int] = None,
        align: int = 128,
    ) -> "PadSpec":
        """Capacity bound implied by HGSampling (:func:`sampler_node_bound`)."""
        node_cap = sampler_node_bound(num_seeds, depth, width, align)
        if default_edge_cap is None:
            default_edge_cap = _round_up(node_cap * 8, align)
        caps = tuple(sorted((k, _round_up(v, align)) for k, v in (edge_caps or {}).items()))
        return cls(node_cap=node_cap, default_edge_cap=default_edge_cap, edge_caps=caps)

    @classmethod
    def calibrate(
        cls,
        sampler,
        seeds_fn,
        n_trials: int = 4,
        headroom: float = 1.5,
        align: int = 128,
        node_bound: Optional[int] = None,
    ) -> "PadSpec":
        """Measure per-meta edge counts over a few sample draws and size the
        caps with headroom. ``seeds_fn()`` must return sampler seed input.
        The node cap is at most ``node_bound`` (:func:`sampler_node_bound`
        of the task's seeds), since no batch fills rows beyond it."""
        import numpy as np

        schema = sampler.schema
        max_nodes = 0
        max_edges: Dict[Tuple[str, str, str], int] = {}
        for _ in range(n_trials):
            s = sampler.sample_raw(seeds_fn())
            max_nodes = max(max_nodes, max(len(v) for v in s.node_ids.values()))
            for meta, (tgt, _src) in s.edges.items():
                max_edges[meta] = max(max_edges.get(meta, 0), len(tgt))
        calibrated = _round_up(int(max_nodes * headroom) + 1, align)
        caps = {
            m: _round_up(int(n * headroom) + 1, align) for m, n in max_edges.items()
        }
        default = max(caps.values()) if caps else _round_up(calibrated * 8, align)
        return cls(
            node_cap=(calibrated if node_bound is None
                      else min(calibrated, node_bound)),
            default_edge_cap=default,
            edge_caps=tuple(sorted(caps.items())),
            node_calibrated=calibrated,
            node_bound=node_bound,
        )


def sampler_node_bound(num_seeds: int, depth: int, width: int,
                       align: int = 128) -> int:
    """The most nodes of one type a batch can hold, rounded up to
    ``align``: HGSampling inserts the seeds, then each of its ``depth``
    rounds at most ``width`` nodes of a type (``pyHGT/data.py:147-172``;
    type-balanced sampling is what makes fixed shapes natural)."""
    return _round_up(num_seeds + depth * width, align)
