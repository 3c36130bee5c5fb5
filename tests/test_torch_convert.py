"""The port's reference-pickle converter against the JAX package's: a
plain-pickled object shaped like the reference's ``Graph`` (built as
``tests/test_datasets.py::test_reference_pickle_roundtrip`` builds it, with
ogbn extras for ``aux``), under each module path the renaming unpickler
maps, converts to equal graphs through both packages, and the port's
``run.load_graph`` falls back to the converter for it."""

import pickle
import sys
import types

import numpy as np
import pytest

from pyhgt_tpu.datasets.convert import convert_reference_pickle as jax_convert
from pyhgt_tpu_torch.datasets.convert import convert_reference_pickle
from pyhgt_tpu_torch.graph.csr import CSRGraph
from test_torch_sampler import _same_graph


def write_reference_pickle(path, module: str) -> None:
    """A reference-shaped graph pickled as ``module.Graph``."""

    class FakeRef:
        pass

    ref = FakeRef()
    ref.node_forward = {"paper": {f"p{i}": i for i in range(4)},
                        "venue": {"v0": 0}}
    ref.node_bacward = {
        "paper": [{"id": f"p{i}", "type": "paper"} for i in range(4)],
        "venue": [{"id": "v0", "type": "venue"}]}
    ref.edge_list = {
        "venue": {"paper": {"PV_in": {0: {0: 2010, 1: 2011}}}},
        "paper": {"venue": {"rev_PV_in": {0: {0: 2010}, 1: {0: 2011}}}},
    }
    ref.times = {2010: True, 2011: True}
    ref.node_feature = {
        "paper": {"emb": np.arange(12, dtype=np.float32).reshape(4, 3)},
        "venue": {"emb": np.zeros((1, 3), np.float32)},
    }
    ref.y = np.array([0, 1, 0, 1])
    ref.train_mask = np.array([True, True, False, False])
    FakeRef.__module__ = module
    FakeRef.__qualname__ = FakeRef.__name__ = "Graph"
    parts = module.split(".")
    mods = {".".join(parts[:i + 1]): types.ModuleType(".".join(parts[:i + 1]))
            for i in range(len(parts))}
    mods[module].Graph = FakeRef
    sys.modules.update(mods)
    try:
        with open(path, "wb") as f:
            pickle.dump(ref, f)
    finally:
        for name in mods:
            del sys.modules[name]


@pytest.mark.parametrize("module", ["GPT_GNN.data", "pyHGT.data", "data"])
def test_converter_matches_jax(tmp_path, module):
    path = tmp_path / "ref.pk"
    write_reference_pickle(path, module)
    got, want = convert_reference_pickle(str(path)), jax_convert(str(path))
    _same_graph(got, want)
    assert got.num_nodes == {"paper": 4, "venue": 1}
    assert got.adj[("venue", "paper", "PV_in")].nnz == 2
    assert set(got.aux) == {"y", "train_mask"}


def test_load_graph_falls_back_to_the_converter(tmp_path):
    """A reference pickle goes through the converter; the port's own
    ``CSRGraph`` pickle still loads as itself."""
    from pyhgt_tpu_torch.run import load_graph

    ref = tmp_path / "ref.pk"
    write_reference_pickle(ref, "GPT_GNN.data")
    g = load_graph(str(ref))
    assert isinstance(g, CSRGraph)
    _same_graph(g, jax_convert(str(ref)))
    own = tmp_path / "own.pk"
    g.save(str(own))
    _same_graph(load_graph(str(own)), g)
