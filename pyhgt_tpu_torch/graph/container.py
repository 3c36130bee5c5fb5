"""Typed temporal heterogeneous multigraph container (build-time API).

A copy of :mod:`pyhgt_tpu.graph.container` (numpy only).

Capability parity with the reference ``Graph`` (reference:
``pyHGT/data.py:19-83``): typed nodes with attribute dicts, typed temporal
edges with automatic ``rev_`` reverse relations, meta-graph enumeration.

Differences by design:

- plain picklable dicts instead of ``defaultdict(lambda: ...)`` towers;
- the build-time container is *not* the runtime structure: call
  :meth:`Graph.freeze` to produce a
  :class:`~pyhgt_tpu_torch.graph.csr.CSRGraph`
  (per-meta-relation CSR arrays) which the sampler and the rest of the
  framework operate on. The reference instead samples directly off the
  dict-of-dicts (``pyHGT/data.py:87-210``) which is host-slow and unusable
  from native code.
- the id->attrs store is named ``node_attrs`` (the reference forked over the
  ``node_bacward``/``node_backward`` typo, see SURVEY.md §0 — we do not
  reproduce the typo; ``node_bacward``/``node_backward`` aliases exist for
  loading reference pickles).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

# Sentinel used for "no timestamp" edges. The reference stores ``None`` and
# patches it to the target's time at sampling (``pyHGT/data.py:124-126``).
NO_TIME = -(2**31)


class Graph:
    """Build-time heterogeneous graph.

    Nodes are dicts with at least ``{'id': hashable, 'type': str}``; extra
    keys become node attributes. Edges live in a 5-level mapping
    ``edge_list[target_type][source_type][relation][target_id][source_id] = time``
    matching the reference layout (``pyHGT/data.py:38-44``) so that existing
    preprocessing recipes translate one-to-one.
    """

    def __init__(self) -> None:
        # type -> {name: int id}
        self.node_forward: Dict[str, Dict[Any, int]] = {}
        # type -> [attr dict per id]
        self.node_attrs: Dict[str, List[dict]] = {}
        # type -> {column: np.ndarray}; filled by set_features / preprocessors
        self.node_feature: Dict[str, Any] = {}
        # [tt][st][rel][tgt_id][src_id] = time
        self.edge_list: Dict[str, Dict[str, Dict[str, Dict[int, Dict[int, Optional[int]]]]]] = {}
        self.times: Dict[Optional[int], bool] = {}

    # -- reference-pickle compatibility aliases ----------------------------
    @property
    def node_bacward(self):  # noqa: D401 - reference name (pyHGT/data.py:31)
        return self.node_attrs

    @property
    def node_backward(self):  # OAG copy's renamed field (OAG/pyHGT/data.py:31)
        return self.node_attrs

    # -- construction -------------------------------------------------------
    def add_node(self, node: dict) -> int:
        """Intern a node, returning its dense per-type integer id.

        Parity: ``pyHGT/data.py:46-53``.
        """
        t = node["type"]
        fwd = self.node_forward.setdefault(t, {})
        key = node["id"]
        ser = fwd.get(key)
        if ser is None:
            ser = len(fwd)
            fwd[key] = ser
            self.node_attrs.setdefault(t, []).append(node)
        return ser

    def add_edge(
        self,
        source_node: dict,
        target_node: dict,
        time: Optional[int] = None,
        relation_type: Optional[str] = None,
        directed: bool = True,
    ) -> None:
        """Add an edge; directed edges get an automatic ``rev_<rel>`` twin.

        Parity: ``pyHGT/data.py:54-64``.
        """
        sid = self.add_node(source_node)
        tid = self.add_node(target_node)
        st, tt = source_node["type"], target_node["type"]
        self._insert(tt, st, relation_type, tid, sid, time)
        if directed:
            self._insert(st, tt, "rev_" + str(relation_type), sid, tid, time)
        else:
            self._insert(st, tt, relation_type, sid, tid, time)
        self.times[time] = True

    def _insert(self, tt: str, st: str, rel: str, tid: int, sid: int, time) -> None:
        self.edge_list.setdefault(tt, {}).setdefault(st, {}).setdefault(rel, {}) \
            .setdefault(tid, {})[sid] = time

    def update_node(self, node: dict) -> None:
        """Merge new attribute keys into an existing (or new) node.

        Parity: ``pyHGT/data.py:66-71``.
        """
        ser = self.add_node(node)
        attrs = self.node_attrs[node["type"]][ser]
        for k, v in node.items():
            if k not in attrs:
                attrs[k] = v

    # -- introspection --------------------------------------------------------
    def get_meta_graph(self) -> List[Tuple[str, str, str]]:
        """Ordered (target_type, source_type, relation) triples.

        Parity: ``pyHGT/data.py:73-80`` (dict insertion order).
        """
        metas = []
        for tt, by_src in self.edge_list.items():
            for st, by_rel in by_src.items():
                for rel in by_rel:
                    metas.append((tt, st, rel))
        return metas

    def get_types(self) -> List[str]:
        """Node types in insertion order (parity: ``pyHGT/data.py:82-83``).

        The reference keys off ``node_feature``; we fall back to
        ``node_forward`` so a graph is introspectable before features are
        attached.
        """
        if self.node_feature:
            return list(self.node_feature.keys())
        return list(self.node_forward.keys())

    def num_nodes(self, node_type: str) -> int:
        return len(self.node_forward.get(node_type, ()))

    def set_features(self, node_type: str, columns: Dict[str, Any]) -> None:
        """Attach per-type feature columns (name -> array-like, row == node id)."""
        self.node_feature[node_type] = dict(columns)

    # -- freezing -------------------------------------------------------------
    def freeze(self):
        """Produce the immutable CSR runtime form. See :class:`CSRGraph`."""
        from pyhgt_tpu_torch.graph.csr import CSRGraph

        return CSRGraph.from_graph(self)

    def __repr__(self) -> str:
        nt = {t: len(f) for t, f in self.node_forward.items()}
        return f"Graph(nodes={nt}, metas={len(self.get_meta_graph())})"


def edge_iter(graph: Graph, tt: str, st: str, rel: str) -> Iterable[Tuple[int, int, Optional[int]]]:
    """Yield (target_id, source_id, time) for one meta-relation."""
    rows = graph.edge_list.get(tt, {}).get(st, {}).get(rel, {})
    for tid, srcs in rows.items():
        for sid, time in srcs.items():
            yield tid, sid, time
