"""The port's graph, sampler, padding and C++ host sort against the JAX
package's: the same arrays and the same generator state give bit-identical
graphs, samples and batches.

The graph is the ogbn-mag proxy (``pyhgt_tpu_torch.datasets.mag_proxy``,
the copy of ``examples/ogbn_mag_scale_proxy.py``'s ``build``) at a tiny
scale; the sampler runs at depth 2 and width 16 from 8 paper seeds.
"""

import dataclasses
import importlib.util
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

from pyhgt_tpu_torch.datasets.mag_proxy import build as port_build
from pyhgt_tpu_torch.graph.csr import CSRGraph, load_pickle
from pyhgt_tpu_torch.native.build import CALLS
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.ops.pallas_seg import PallasSegAux
from pyhgt_tpu_torch.sampling.batch import (
    BatchLayout, pad_sample, stack_batches,
)
from pyhgt_tpu_torch.sampling.hgsampler import HGSampler, RawSample
from pyhgt_tpu_torch.sampling.native import NativeHGSampler
from pyhgt_tpu_torch.sampling.sorted_batch import sort_edges
from pyhgt_tpu_torch.tasks.base import gather_features

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCALE = 0.002      # 1,472 papers, 2,269 authors, 84,440 directed edges
DEPTH, WIDTH, N_SEEDS = 2, 16, 8


def _jax_proxy():
    spec = importlib.util.spec_from_file_location(
        "ogbn_mag_scale_proxy", ROOT / "examples" / "ogbn_mag_scale_proxy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def graphs():
    """(JAX CSRGraph, port CSRGraph) of the proxy from the same seed."""
    return _jax_proxy().build(SCALE, seed=0), port_build(SCALE, seed=0)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, what)


def _same_graph(g, j):
    assert g.num_nodes == j.num_nodes
    assert g.schema.node_types == j.schema.node_types
    assert [m.as_tuple() for m in g.schema.metas] == [
        m.as_tuple() for m in j.schema.metas]
    assert g.schema.relation_names == j.schema.relation_names
    assert g.adj.keys() == j.adj.keys()
    for k, a in g.adj.items():
        for f in ("indptr", "src", "time"):
            _same(getattr(a, f), getattr(j.adj[k], f), f"{k}.{f}")
    assert g.features.keys() == j.features.keys()
    for t, cols in g.features.items():
        assert cols.keys() == j.features[t].keys()
        for c, v in cols.items():
            _same(v, j.features[t][c], f"feat {t}.{c}")
    _same(g.times, j.times, "times")
    assert g.aux.keys() == j.aux.keys()
    for k, v in g.aux.items():
        _same(v, j.aux[k], f"aux {k}")


def test_proxy_graph_matches_jax(graphs):
    """The proxy's schema, CSR arrays, features (x ∥ log10 deg), labels and
    splits equal the JAX package's, array for array."""
    j, g = graphs
    _same_graph(g, j)
    assert g.features["paper"]["emb"].shape[1] == 129


def _toy_edges(mod):
    """The same small typed temporal graph, built through the ``Graph``
    container of ``mod`` (either package's ``graph.container``)."""
    r = np.random.default_rng(4)
    g = mod.Graph()
    papers = [{"id": f"p{i}", "type": "paper"} for i in range(30)]
    authors = [{"id": f"a{i}", "type": "author"} for i in range(12)]
    for i, p in enumerate(papers):
        t = int(r.integers(2000, 2020)) if i % 7 else None
        for a in r.choice(12, size=r.integers(1, 4), replace=False):
            g.add_edge(authors[a], p, time=t, relation_type="AP_write")
        for k in r.choice(30, size=r.integers(0, 3), replace=False):
            if k != i:
                g.add_edge(papers[int(k)], p, time=t, relation_type="PP_cite")
    g.set_features("paper", {"emb": r.normal(size=(30, 4)).astype(np.float32)})
    g.set_features("author", {"emb": r.normal(size=(12, 4)).astype(np.float32)})
    return g


def test_from_graph_matches_jax():
    """``Graph.freeze`` (``CSRGraph.from_graph``), untimed edges included."""
    from pyhgt_tpu.graph import container as jax_container
    from pyhgt_tpu_torch.graph import container

    j = _toy_edges(jax_container).freeze()
    g = _toy_edges(container).freeze()
    assert isinstance(g, CSRGraph)
    _same_graph(g, j)


_LOAD_WITHOUT_JAX = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from pyhgt_tpu_torch.graph.csr import CSRGraph
g = CSRGraph.load_dir({d!r}, mmap=True)
p = CSRGraph.load({pk!r})
assert isinstance(g.adj[g.schema.metas[0].as_tuple()].src, np.memmap)
assert type(g.schema).__module__ == "pyhgt_tpu_torch.graph.schema"
assert type(p.schema).__module__ == "pyhgt_tpu_torch.graph.schema"
bad = [m for m in sys.modules if m == "pyhgt_tpu" or m.startswith("pyhgt_tpu.")]
assert not bad, bad
print(g.num_edges(), p.num_edges(), g.schema.rel_id("rev_writes"),
      g.schema.num_relations)
"""


def test_jax_save_dir_loads_without_the_jax_package(graphs, tmp_path):
    """A ``save_dir`` and a ``save`` pickle written by the JAX package load
    in a process that never imports it (the pickled ``GraphSchema`` maps
    onto the port's class), as memory maps, equal to the JAX graph."""
    j, g = graphs
    d, pk = tmp_path / "graph", tmp_path / "graph.pk"
    j.save_dir(str(d))
    j.save(str(pk))
    out = subprocess.run(
        [sys.executable, "-c", _LOAD_WITHOUT_JAX.format(
            root=str(ROOT), d=str(d), pk=str(pk))],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, n_pk, rel, n_rel = map(int, out.stdout.split())
    assert n == n_pk == j.num_edges()
    assert (rel, n_rel) == (j.schema.rel_id("rev_writes"),
                            j.schema.num_relations)
    _same_graph(CSRGraph.load_dir(str(d)), j)
    _same_graph(CSRGraph.load(str(pk)), j)


def test_unpickler_refuses_other_jax_modules(tmp_path):
    from pyhgt_tpu.sampling.hgsampler import RawSample as JaxRawSample

    path = tmp_path / "other.pk"
    with open(path, "wb") as f:
        pickle.dump(JaxRawSample({}, {}, {}, {}), f)
    with open(path, "rb") as f, pytest.raises(pickle.UnpicklingError,
                                              match="refusing"):
        load_pickle(f)


def _seeds(graph, seed):
    rng = np.random.default_rng(100 + seed)
    ids = rng.choice(graph.num_nodes["paper"], N_SEEDS, replace=False)
    return {"paper": np.stack([ids, graph.aux["years"][ids]], axis=1)}


def _same_sample(s, j):
    assert s.seed_counts == j.seed_counts
    assert s.node_ids.keys() == j.node_ids.keys()
    for t in s.node_ids:
        _same(s.node_ids[t], j.node_ids[t], f"ids {t}")
        _same(s.node_time[t], j.node_time[t], f"time {t}")
    assert s.edges.keys() == j.edges.keys()
    for m, (tgt, src) in s.edges.items():
        _same(tgt, j.edges[m][0], f"tgt {m}")
        _same(src, j.edges[m][1], f"src {m}")


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "cpp"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_raw_bit_identical(graphs, native, seed):
    """Both samplers under equal ``default_rng(seed)``: the same subgraph
    as the JAX package's, and the generators end in the same state."""
    if native:
        from pyhgt_tpu.sampling.native import NativeHGSampler as JaxSampler
        ours = NativeHGSampler
    else:
        from pyhgt_tpu.sampling.hgsampler import HGSampler as JaxSampler
        ours = HGSampler
    j, g = graphs
    seeds = _seeds(g, seed)
    r_j, r_t = np.random.default_rng(seed), np.random.default_rng(seed)
    before = CALLS["hgs_sample"]
    s = ours(g, depth=DEPTH, width=WIDTH).sample_raw(seeds, rng=r_t)
    js = JaxSampler(j, depth=DEPTH, width=WIDTH).sample_raw(seeds, rng=r_j)
    assert CALLS["hgs_sample"] == before + int(native)
    _same_sample(s, js)
    assert sum(len(v) for v in s.node_ids.values()) > N_SEEDS
    assert r_t.integers(1 << 30) == r_j.integers(1 << 30)


def _layout(graph, node_cap, edge_cap):
    from pyhgt_tpu_torch.graph.schema import PadSpec

    return BatchLayout(schema=graph.schema, pad=PadSpec(
        node_cap=node_cap, default_edge_cap=edge_cap))


def _to_jax_sample(s):
    from pyhgt_tpu.sampling.hgsampler import RawSample as JaxRawSample

    return JaxRawSample(**{f.name: getattr(s, f.name)
                           for f in dataclasses.fields(RawSample)})


@pytest.mark.parametrize("edge_cap", [512, 128], ids=["fits", "overflow"])
def test_pad_sample_bit_identical(graphs, edge_cap):
    """``pad_sample`` of one sample, with the edge caps large enough and so
    small that blocks overflow (the kept subset drawn from the rng)."""
    from pyhgt_tpu.graph.schema import PadSpec as JaxPad
    from pyhgt_tpu.sampling.batch import BatchLayout as JaxLayout
    from pyhgt_tpu.sampling.batch import pad_sample as jax_pad
    from pyhgt_tpu.tasks.base import gather_features as jax_gather

    j, g = graphs
    s = NativeHGSampler(g, depth=DEPTH, width=WIDTH).sample_raw(
        _seeds(g, 0), rng=np.random.default_rng(3))
    layout = _layout(g, 64, edge_cap)
    jl = JaxLayout(schema=j.schema, pad=JaxPad(node_cap=64,
                                               default_edge_cap=edge_cap))
    js = _to_jax_sample(s)
    r_j, r_t = np.random.default_rng(7), np.random.default_rng(7)
    b = pad_sample(s, layout, gather_features(g, s), rng=r_t)
    jb = jax_pad(js, jl, jax_gather(j, js), rng=r_j)
    for f in dataclasses.fields(b):
        _same(getattr(b, f.name), getattr(jb, f.name), f.name)
    assert (b.block_overflow.sum() > 0) == (edge_cap == 128)
    assert r_t.integers(1 << 30) == r_j.integers(1 << 30)
    stacked = stack_batches([b, b])
    assert stacked.edge_src.shape == (2,) + b.edge_src.shape
    _same(layout.seed_slice("author", 3), jl.seed_slice("author", 3), "slice")


def _same_sorted(a, b, what=""):
    """Every field of the port's SortedEdges ``a`` equal, value and dtype,
    to the same-named field of ``b`` (either package's)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        name = f"{what}{f.name}"
        assert (x is None) == (y is None), name
        if x is None:
            continue
        if isinstance(x, PallasSegAux):
            for k in ("loc", "blk", "ptr2", "live_key"):
                assert (getattr(x, k) is None) == (getattr(y, k) is None)
                if getattr(x, k) is not None:
                    _same(getattr(x, k), getattr(y, k), f"{name}.{k}")
            assert (x.w, x.v) == (y.w, y.v), name
            if hasattr(y, "window"):
                assert (x.window, x.dead_rows) == (y.window, y.dead_rows)
        elif isinstance(x, np.ndarray):
            _same(x, y, name)
        else:
            assert x == y, name


# rank cap 128 holds for the target and the singleton-split src aux of the
# sampled batch (its tiles hold up to ~100 target segments), 64 does not
# (both fall back to the legacy aux); tab cap 64 holds in both
CAPS = {"no-caps": {},
        "caps-hold": dict(tgt_rank_cap=128, tab_cap=64, src_rank_cap=128,
                          src_split_cap=128),
        "caps-violated": dict(tgt_rank_cap=64, tab_cap=64, src_rank_cap=64,
                              src_split_cap=64)}


@pytest.fixture(scope="module")
def sampled_batch(graphs):
    """A padded batch of a real sample whose blocks span several kernel
    tiles (node cap 512, edge cap 1,024)."""
    _, g = graphs
    s = NativeHGSampler(g, depth=3, width=64).sample_raw(
        _seeds(g, 5), rng=np.random.default_rng(11))
    layout = _layout(g, 512, 1024)
    return layout, pad_sample(s, layout, gather_features(g, s),
                              rng=np.random.default_rng(0))


@pytest.mark.parametrize("caps", list(CAPS))
def test_native_sort_bit_identical(graphs, sampled_batch, caps):
    """The port's C++ sort against its numpy path (every field, with and
    without the backward's aux) and against the JAX package's numpy path,
    on a sampled batch with the kernel aux, rank caps off and on."""
    from pyhgt_tpu.graph.schema import PadSpec as JaxPad
    from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JaxMeta
    from pyhgt_tpu.sampling.batch import BatchLayout as JaxLayout
    from pyhgt_tpu.sampling.sorted_batch import sort_edges as jax_sort

    j, _ = graphs
    layout, b = sampled_batch
    em = EdgeStaticMeta.from_layout(layout)
    args = (b.edge_src, b.edge_tgt, b.edge_dt, b.edge_mask, layout, em)
    kw = CAPS[caps]
    for with_backward in (True, False):
        before = CALLS["sb_permute_build"]
        c = sort_edges(*args, native=True, with_backward=with_backward, **kw)
        assert CALLS["sb_permute_build"] == before + 1
        n = sort_edges(*args, native=False, with_backward=with_backward, **kw)
        assert CALLS["sb_permute_build"] == before + 1
        _same_sorted(c, n, f"backward={with_backward}: ")
    assert c.ptab_src is None and c.pseg_src is None
    c = sort_edges(*args, native=True, **kw)
    assert c.ptab_src is not None and c.ptab_src.window
    jl = JaxLayout(schema=j.schema, pad=JaxPad(node_cap=512,
                                               default_edge_cap=1024))
    je = jax_sort(b.edge_src, b.edge_tgt, b.edge_dt, b.edge_mask, jl,
                  JaxMeta.from_layout(jl), native=False, **kw)
    _same_sorted(c, je, "JAX: ")
    assert (c.tab_sel is not None) == bool(kw)
    assert c.pseg_tgt.v == (128 if caps == "caps-hold" else 0)
    assert (c.pseg_src_multi is not None) == (caps == "caps-hold")


def test_native_sort_refuses_when_asked_and_unbuilt(monkeypatch, sampled_batch):
    from pyhgt_tpu_torch.sampling import sorted_batch

    layout, b = sampled_batch
    monkeypatch.setattr(sorted_batch, "_NATIVE_OK", False)
    with pytest.raises(RuntimeError, match="native batch prep"):
        sort_edges(b.edge_src, b.edge_tgt, b.edge_dt, b.edge_mask, layout,
                   native=True)
    before = CALLS["sb_counting_sort"]
    sort_edges(b.edge_src, b.edge_tgt, b.edge_dt, b.edge_mask, layout)
    assert CALLS["sb_counting_sort"] == before   # the numpy path ran
