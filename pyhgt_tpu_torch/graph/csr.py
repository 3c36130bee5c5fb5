"""Frozen CSR runtime graph.

A copy of :mod:`pyhgt_tpu.graph.csr` (numpy only), with one difference:
pickles are read through :func:`load_pickle`, whose unpickler maps the JAX
package's graph classes (``pyhgt_tpu.graph.*``) onto this package's
(``pyhgt_tpu_torch.graph.*``) and refuses any other module of the JAX
package, so a graph the JAX package wrote (``save`` or ``save_dir``) loads
here without importing it.

The reference samples directly off a 5-level dict-of-dicts
(``pyHGT/data.py:38-44, 87-210``), which is cache-hostile and unusable from
native code. Here each meta-relation (target_type, source_type, relation)
freezes into a CSR adjacency *indexed by target id*: ``indptr[tgt]`` slices
into ``src`` / ``time`` arrays — exactly the access pattern HGSampling's
``add_budget`` needs (neighbors of a target, per meta-relation).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pyhgt_tpu_torch.graph.container import NO_TIME, Graph
from pyhgt_tpu_torch.graph.schema import GraphSchema, MetaRelation

MetaKey = Tuple[str, str, str]

_JAX_PKG = "pyhgt_tpu"


class _PortUnpickler(pickle.Unpickler):
    """Reads the JAX package's graph pickles with this package's classes:
    ``pyhgt_tpu.graph.<mod>`` -> ``pyhgt_tpu_torch.graph.<mod>``; any other
    module of the JAX package is refused."""

    def find_class(self, module, name):
        if module == _JAX_PKG or module.startswith(_JAX_PKG + "."):
            if not module.startswith(_JAX_PKG + ".graph."):
                raise pickle.UnpicklingError(
                    f"refusing {module}.{name}: only graph classes of the "
                    "JAX package have a counterpart here")
            module = "pyhgt_tpu_torch" + module[len(_JAX_PKG):]
        return super().find_class(module, name)


def load_pickle(f):
    """``pickle.load`` of an open binary file through the mapping
    unpickler."""
    return _PortUnpickler(f).load()


@dataclasses.dataclass
class CSRAdj:
    """CSR adjacency for one meta-relation, rows = target ids of tgt_type."""

    indptr: np.ndarray  # [num_targets + 1] int64
    src: np.ndarray     # [nnz] int32  (source ids within src_type)
    time: np.ndarray    # [nnz] int32  (NO_TIME where the edge is untimed)

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    def row(self, tgt: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[tgt], self.indptr[tgt + 1]
        return self.src[lo:hi], self.time[lo:hi]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


@dataclasses.dataclass
class CSRGraph:
    """Immutable heterogeneous graph: schema + per-meta CSR + features."""

    schema: GraphSchema
    num_nodes: Dict[str, int]
    adj: Dict[MetaKey, CSRAdj]
    # type -> {column: np.ndarray row-indexed by node id}
    features: Dict[str, Dict[str, np.ndarray]]
    # distinct edge timestamps (excluding NO_TIME), sorted
    times: np.ndarray
    # free-form task payloads (labels, split masks, ...)
    aux: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_graph(cls, graph: Graph, schema: Optional[GraphSchema] = None) -> "CSRGraph":
        schema = schema or GraphSchema.from_graph(graph)
        num_nodes = {t: graph.num_nodes(t) for t in schema.node_types}
        adj: Dict[MetaKey, CSRAdj] = {}
        for m in schema.metas:
            rows = graph.edge_list.get(m.tgt_type, {}).get(m.src_type, {}).get(m.rel, {})
            n_tgt = num_nodes[m.tgt_type]
            counts = np.zeros(n_tgt + 1, dtype=np.int64)
            for tid, srcs in rows.items():
                counts[tid + 1] = len(srcs)
            indptr = np.cumsum(counts)
            nnz = int(indptr[-1])
            src = np.empty(nnz, dtype=np.int32)
            time = np.empty(nnz, dtype=np.int32)
            for tid, srcs in rows.items():
                lo = indptr[tid]
                for k, (sid, t) in enumerate(srcs.items()):
                    src[lo + k] = sid
                    time[lo + k] = NO_TIME if t is None else int(t)
            adj[m.as_tuple()] = CSRAdj(indptr=indptr, src=src, time=time)
        feats = {
            t: {k: np.asarray(v) for k, v in cols.items()}
            for t, cols in graph.node_feature.items()
        }
        ts = sorted(t for t in graph.times if t is not None)
        return cls(
            schema=schema,
            num_nodes=num_nodes,
            adj=adj,
            features=feats,
            times=np.asarray(ts, dtype=np.int64),
        )

    @classmethod
    def from_arrays(
        cls,
        schema: GraphSchema,
        num_nodes: Dict[str, int],
        edges: Dict[MetaKey, Tuple[np.ndarray, np.ndarray, np.ndarray]],
        features: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
        aux: Optional[Dict[str, Any]] = None,
    ) -> "CSRGraph":
        """Bulk-build from (tgt, src, time) edge triples per meta-relation —
        the fast path for array-native datasets (e.g. ogbn-mag)."""
        adj: Dict[MetaKey, CSRAdj] = {}
        all_times = set()
        for m in schema.metas:
            key = m.as_tuple()
            n_tgt = num_nodes[m.tgt_type]
            if key in edges:
                tgt, src, time = edges[key]
                tgt = np.asarray(tgt, dtype=np.int64)
                src = np.asarray(src, dtype=np.int32)
                time = np.asarray(time, dtype=np.int32)
                order = np.argsort(tgt, kind="stable")
                tgt, src, time = tgt[order], src[order], time[order]
                indptr = np.searchsorted(tgt, np.arange(n_tgt + 1))
                adj[key] = CSRAdj(indptr=indptr, src=src, time=time)
                all_times.update(np.unique(time[time != NO_TIME]).tolist())
            else:
                adj[key] = CSRAdj(
                    indptr=np.zeros(n_tgt + 1, dtype=np.int64),
                    src=np.empty(0, dtype=np.int32),
                    time=np.empty(0, dtype=np.int32),
                )
        return cls(
            schema=schema,
            num_nodes=num_nodes,
            adj=adj,
            features=features or {},
            times=np.asarray(sorted(all_times), dtype=np.int64),
            aux=aux or {},
        )

    # -- queries ---------------------------------------------------------------
    def metas_targeting(self, node_type: str) -> List[MetaRelation]:
        """Meta-relations whose target type is ``node_type`` (the relations
        HGSampling expands through when a node of this type is sampled)."""
        return [m for m in self.schema.metas if m.tgt_type == node_type]

    def neighbors(self, meta: MetaKey, tgt: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.adj[meta].row(tgt)

    def num_edges(self) -> int:
        return sum(a.nnz for a in self.adj.values())

    # -- io ----------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def load(path: str) -> "CSRGraph":
        with open(path, "rb") as f:
            g = load_pickle(f)
        if not isinstance(g, CSRGraph):
            raise TypeError(f"{path} does not contain a CSRGraph (got {type(g)})")
        return g

    # Directory layout for memory-mapped storage: big arrays as individual
    # .npy files (loadable with mmap_mode so an 8 GB OAG graph costs no
    # resident RAM until touched — the reference dill-loads the whole
    # multi-GB pickle up front, OAG/train_paper_field.py:72),
    # plus a small pickle for the schema/metadata.
    def save_dir(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        meta = {
            "schema": self.schema,
            "num_nodes": self.num_nodes,
            "metas": [m.as_tuple() for m in self.schema.metas],
            "times": self.times,
            "feature_keys": {
                t: list(cols.keys()) for t, cols in self.features.items()
            },
            "aux_keys": list(self.aux.keys()),
        }
        with open(os.path.join(path, "meta.pk"), "wb") as f:
            pickle.dump(meta, f)
        for i, m in enumerate(self.schema.metas):
            adj = self.adj[m.as_tuple()]
            np.save(os.path.join(path, f"adj{i}_indptr.npy"), adj.indptr)
            np.save(os.path.join(path, f"adj{i}_src.npy"), adj.src)
            np.save(os.path.join(path, f"adj{i}_time.npy"), adj.time)
        for t, cols in self.features.items():
            for k, v in cols.items():
                np.save(os.path.join(path, f"feat_{t}_{k}.npy"),
                        np.asarray(v))
        for k, v in self.aux.items():
            np.save(os.path.join(path, f"aux_{k}.npy"), np.asarray(v))

    @staticmethod
    def load_dir(path: str, mmap: bool = True) -> "CSRGraph":
        import os

        mode = "r" if mmap else None
        with open(os.path.join(path, "meta.pk"), "rb") as f:
            meta = load_pickle(f)
        schema = meta["schema"]
        adj = {}
        for i, m in enumerate(schema.metas):
            adj[m.as_tuple()] = CSRAdj(
                indptr=np.load(os.path.join(path, f"adj{i}_indptr.npy"),
                               mmap_mode=mode),
                src=np.load(os.path.join(path, f"adj{i}_src.npy"),
                            mmap_mode=mode),
                time=np.load(os.path.join(path, f"adj{i}_time.npy"),
                             mmap_mode=mode),
            )
        feats = {
            t: {
                k: np.load(os.path.join(path, f"feat_{t}_{k}.npy"),
                           mmap_mode=mode, allow_pickle=False)
                for k in keys
            }
            for t, keys in meta["feature_keys"].items()
        }
        aux = {
            k: np.load(os.path.join(path, f"aux_{k}.npy"), mmap_mode=mode)
            for k in meta["aux_keys"]
        }
        return CSRGraph(
            schema=schema,
            num_nodes=meta["num_nodes"],
            adj=adj,
            features=feats,
            times=np.asarray(meta["times"]),
            aux=aux,
        )

    def __repr__(self) -> str:
        return (
            f"CSRGraph(types={dict(self.num_nodes)}, "
            f"metas={len(self.schema.metas)}, edges={self.num_edges()})"
        )
