"""ctypes binding: NativeHGSampler — drop-in C++ HGSampling.

Counterpart of :mod:`pyhgt_tpu.sampling.native`, over this package's own
copy of the C++ source (:mod:`pyhgt_tpu_torch.native.build`). Same
``sample_raw`` contract as
:class:`~pyhgt_tpu_torch.sampling.hgsampler.HGSampler` (seeds-first serial
order, induced edges as local index pairs), with the budget loop and
reconstruction running in C++ (GIL released during the call).

RNG is the library's own splitmix64, seeded by one 63-bit draw from the
caller's ``numpy`` generator: the same generator state gives the same
sample as the JAX package's native sampler, bit for bit, but not the numpy
sampler's (parity between the two is distributional).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from pyhgt_tpu_torch.graph.csr import CSRGraph, MetaKey
from pyhgt_tpu_torch.native.build import CALLS, load_library
from pyhgt_tpu_torch.sampling.hgsampler import RawSample


class NativeHGSampler:
    def __init__(
        self,
        graph: CSRGraph,
        depth: int = 6,
        width: int = 128,
        time_max: Optional[int] = None,
        edge_cap_factor: int = 16,
    ) -> None:
        self.graph = graph
        self.schema = graph.schema
        self.depth = depth
        self.width = width
        self.time_max = time_max
        self._lib = load_library()
        c = ctypes

        metas = [m.as_tuple() for m in self.schema.metas]
        self._metas = metas
        T = self.schema.num_types
        M = len(metas)
        type_id = {t: i for i, t in enumerate(self.schema.node_types)}

        # keep array refs alive for the lifetime of the handle
        self._keep = []
        meta_tgt = (c.c_int * M)(*[type_id[m[0]] for m in metas])
        meta_src = (c.c_int * M)(*[type_id[m[1]] for m in metas])
        indptrs = (c.POINTER(c.c_int64) * M)()
        n_rows = (c.c_int64 * M)()
        srcs = (c.POINTER(c.c_int32) * M)()
        times = (c.POINTER(c.c_int32) * M)()
        for i, m in enumerate(metas):
            adj = graph.adj[m]
            ip = np.ascontiguousarray(adj.indptr, dtype=np.int64)
            sr = np.ascontiguousarray(adj.src, dtype=np.int32)
            tm = np.ascontiguousarray(adj.time, dtype=np.int32)
            self._keep += [ip, sr, tm]
            indptrs[i] = ip.ctypes.data_as(c.POINTER(c.c_int64))
            n_rows[i] = ip.shape[0] - 1
            srcs[i] = sr.ctypes.data_as(c.POINTER(c.c_int32))
            times[i] = tm.ctypes.data_as(c.POINTER(c.c_int32))
        self._keep += [meta_tgt, meta_src, indptrs, n_rows, srcs, times]
        self._handle = self._lib.hgs_graph_create(
            T, M, meta_tgt, meta_src, indptrs, n_rows, srcs, times
        )
        self._type_id = type_id
        # generous output capacities (padding subsamples overflow anyway)
        self._node_cap = 0
        self._edge_cap = edge_cap_factor

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.hgs_graph_destroy(h)
            self._handle = None

    # ------------------------------------------------------------------
    def sample_raw(
        self,
        seeds: Dict[str, np.ndarray],
        rng: Optional[np.random.Generator] = None,
        time_max: Optional[int] = ...,  # Ellipsis sentinel: sampler default
        seed: Optional[int] = None,
    ) -> RawSample:
        c = ctypes
        if time_max is ...:  # Ellipsis = "use the sampler default"
            time_max = self.time_max
        if seed is None:
            seed = int((rng or np.random.default_rng()).integers(0, 2**63 - 1))

        st_list, sid_list, stm_list = [], [], []
        for t, arr in seeds.items():
            arr = np.asarray(arr)
            ti = self._type_id[t]
            for nid, ntime in arr:
                st_list.append(ti)
                sid_list.append(int(nid))
                stm_list.append(int(ntime))
        n_seeds = len(sid_list)
        seed_types = np.asarray(st_list, dtype=np.int32)
        seed_ids = np.asarray(sid_list, dtype=np.int64)
        seed_times = np.asarray(stm_list, dtype=np.int32)

        T = self.schema.num_types
        M = len(self._metas)
        max_per_type_seeds = max(
            (len(np.asarray(a)) for a in seeds.values()), default=0
        )
        node_cap = max_per_type_seeds + self.depth * self.width + 1
        edge_cap = self._edge_cap * node_cap

        node_ids = np.zeros(T * node_cap, dtype=np.int64)
        node_times = np.zeros(T * node_cap, dtype=np.int32)
        node_counts = np.zeros(T, dtype=np.int64)
        edge_tgt = np.zeros(M * edge_cap, dtype=np.int32)
        edge_src = np.zeros(M * edge_cap, dtype=np.int32)
        edge_counts = np.zeros(M, dtype=np.int64)

        CALLS["hgs_sample"] += 1
        rc = self._lib.hgs_sample(
            self._handle, c.c_uint64(seed),
            self.depth, self.width,
            c.c_int64(time_max if time_max is not None else 0),
            1 if time_max is not None else 0,
            seed_types.ctypes.data_as(c.POINTER(c.c_int)),
            seed_ids.ctypes.data_as(c.POINTER(c.c_int64)),
            seed_times.ctypes.data_as(c.POINTER(c.c_int32)),
            c.c_int64(n_seeds),
            c.c_int64(node_cap),
            node_ids.ctypes.data_as(c.POINTER(c.c_int64)),
            node_times.ctypes.data_as(c.POINTER(c.c_int32)),
            node_counts.ctypes.data_as(c.POINTER(c.c_int64)),
            c.c_int64(edge_cap),
            edge_tgt.ctypes.data_as(c.POINTER(c.c_int32)),
            edge_src.ctypes.data_as(c.POINTER(c.c_int32)),
            edge_counts.ctypes.data_as(c.POINTER(c.c_int64)),
        )
        if rc != 0:
            raise RuntimeError(f"hgs_sample failed with code {rc}")

        out_ids: Dict[str, np.ndarray] = {}
        out_times: Dict[str, np.ndarray] = {}
        for t, name in enumerate(self.schema.node_types):
            n = int(min(node_counts[t], node_cap))
            out_ids[name] = node_ids[t * node_cap : t * node_cap + n].copy()
            out_times[name] = node_times[t * node_cap : t * node_cap + n].astype(
                np.int64
            )
        edges: Dict[MetaKey, Tuple[np.ndarray, np.ndarray]] = {}
        for i, m in enumerate(self._metas):
            n = int(min(edge_counts[i], edge_cap))
            if n:
                edges[m] = (
                    edge_tgt[i * edge_cap : i * edge_cap + n].copy(),
                    edge_src[i * edge_cap : i * edge_cap + n].copy(),
                )
        seed_counts = {t: len(np.asarray(a)) for t, a in seeds.items()}
        return RawSample(
            node_ids=out_ids,
            node_time=out_times,
            edges=edges,
            seed_counts=seed_counts,
        )
