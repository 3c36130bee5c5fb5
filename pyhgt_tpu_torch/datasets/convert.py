"""Load graphs pickled by the reference (or its GPT-GNN sibling) and
convert them to this package's Graph / CSRGraph.

A copy of :mod:`pyhgt_tpu.datasets.convert`. ``RenameUnpickler`` /
``renamed_load`` (the reference's ``pyHGT/data.py:260-269``) remap the
pickled module paths ``GPT_GNN.data`` / ``data`` / ``pyHGT.data`` onto a
shim class here, so multi-GB reference pickles load without the reference package installed.
The reference pickles with dill (its Graph holds defaultdict(lambda)
towers); if ``dill`` is unavailable this loader still works for pickles
whose defaultdicts were cleaned to plain dicts (the OAG preprocessor's
final step does exactly that, ``preprocess_OAG.py:397-425``).
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from typing import Any

import numpy as np

from pyhgt_tpu_torch.graph.container import Graph
from pyhgt_tpu_torch.graph.csr import CSRGraph


class _RefGraphShim:
    """Instance shell for unpickled reference Graph objects — attributes
    land via ``__dict__`` (``node_forward``, ``node_bacward``/
    ``node_backward``, ``node_feature``, ``edge_list``, ``times``, plus
    ogbn extras like ``y``/``train_mask``)."""

    def __init__(self, *a, **k):
        pass


class _RenameUnpickler(pickle.Unpickler):
    _MAP = {"GPT_GNN.data", "data", "pyHGT.data"}

    def find_class(self, module, name):
        if module in self._MAP and name == "Graph":
            return _RefGraphShim
        if module in self._MAP:
            module = "pyhgt_tpu_torch.datasets.convert"
            if not hasattr(_this_module(), name):
                return _RefGraphShim
        return super().find_class(module, name)


def _this_module():
    import pyhgt_tpu_torch.datasets.convert as m

    return m


def renamed_load(file_obj) -> Any:
    """Reference-compatible loader (``pyHGT/data.py:268-269``)."""
    try:
        return _RenameUnpickler(file_obj).load()
    except Exception:
        try:
            import dill

            class _DillRename(dill.Unpickler):
                def find_class(self, module, name):
                    if module in _RenameUnpickler._MAP and name == "Graph":
                        return _RefGraphShim
                    return super().find_class(module, name)

            file_obj.seek(0)
            return _DillRename(file_obj).load()
        except ImportError as e:
            raise RuntimeError(
                "pickle needs dill-specific reducers but dill is not "
                "installed; re-export the graph with plain dicts"
            ) from e


def _plain(d):
    """Recursively strip defaultdicts (drops unpicklable factories)."""
    if isinstance(d, defaultdict) or isinstance(d, dict):
        return {k: _plain(v) for k, v in d.items()}
    return d


def from_reference_graph(ref: Any) -> Graph:
    """Build our Graph from an unpickled reference Graph object."""
    g = Graph()
    g.node_forward = _plain(getattr(ref, "node_forward", {}))
    attrs = getattr(ref, "node_bacward", None)
    if attrs is None:
        attrs = getattr(ref, "node_backward", {})
    g.node_attrs = _plain(attrs) if isinstance(attrs, dict) else dict(attrs)
    g.edge_list = _plain(getattr(ref, "edge_list", {}))
    g.times = dict(getattr(ref, "times", {}))
    # node_feature: pandas DataFrames in OAG pickles; dict/arrays in ogbn
    nf = getattr(ref, "node_feature", {})
    for t, frame in dict(nf).items():
        if hasattr(frame, "columns"):  # DataFrame -> column dict
            cols = {}
            for c in frame.columns:
                col = frame[c].values
                if len(col) and isinstance(col[0], (list, np.ndarray)):
                    cols[c] = np.stack([np.asarray(v) for v in col])
                else:
                    cols[c] = np.asarray(col)
            g.node_feature[t] = cols
        elif isinstance(frame, dict):
            g.node_feature[t] = {k: np.asarray(v) for k, v in frame.items()}
        else:
            g.node_feature[t] = {"emb": np.asarray(frame)}
    return g


def convert_reference_pickle(path: str) -> CSRGraph:
    """Reference pickle -> CSRGraph, carrying ogbn extras into ``aux``."""
    with open(path, "rb") as f:
        ref = renamed_load(f)
    g = from_reference_graph(ref)
    csr = g.freeze()
    for key in ("y", "years", "train_mask", "valid_mask", "test_mask",
                "train_paper", "valid_paper", "test_paper"):
        if hasattr(ref, key):
            csr.aux[key] = np.asarray(getattr(ref, key))
    return csr
