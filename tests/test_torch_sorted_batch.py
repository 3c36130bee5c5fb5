"""The port's host layout against the JAX package's: the schema's blocks,
the static edge metadata, the RTE table, ``synth_batch`` and the numpy path
of ``sort_batch`` must give bit-identical arrays for the same inputs."""

import dataclasses

import numpy as np
import pytest

from pyhgt_tpu.flagship import build_flagship as jax_build
from pyhgt_tpu.flagship import synth_flagship_batch as jax_synth
from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JaxMeta
from pyhgt_tpu.ops.rte import rte_sin_table as jax_rte
from pyhgt_tpu.sampling.sorted_batch import sort_batch as jax_sort
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.ops.pallas_seg import PK
from pyhgt_tpu_torch.ops.rte import rte_sin_table
from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch

# every SortedEdges field the inference forward reads
FORWARD_FIELDS = (
    "edge_src", "edge_tgt", "edge_mask", "gidx", "tabidx", "rel_onehot",
    "tl_tgt", "live_idx_tgt", "live_key_tgt", "live_last_tgt",
    "seg_ptr2_tgt", "tab_sel",
)


@pytest.fixture(scope="module")
def flagships():
    return jax_build("tiny"), build_flagship("tiny", device="cpu")


def _same(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what


def test_layout_blocks_and_static_meta_match(flagships):
    jf, tf = flagships
    # the two packages' dataclasses differ by class, not by content
    assert [dataclasses.astuple(b) for b in tf.layout.blocks] == [
        dataclasses.astuple(b) for b in jf.layout.blocks]
    assert tf.layout.num_edges == jf.layout.num_edges
    jm, tm = JaxMeta.from_layout(jf.layout), EdgeStaticMeta.from_layout(tf.layout)
    for f in dataclasses.fields(tm):
        _same(getattr(tm, f.name), getattr(jm, f.name), f.name)


@pytest.mark.parametrize("n_hid", [128, 512])
def test_rte_table_matches(n_hid):
    _same(rte_sin_table(n_hid), jax_rte(n_hid), "rte table")


@pytest.mark.parametrize("seed,fill", [(0, 1.0), (3, 0.5)])
def test_synth_batch_bit_identical(flagships, seed, fill):
    jf, tf = flagships
    jb, jl = jax_synth(jf, seed, edge_fill=fill)
    tb, tl = synth_flagship_batch(tf, seed, edge_fill=fill)
    for f in dataclasses.fields(tb):
        _same(getattr(tb, f.name), getattr(jb, f.name), f.name)
    _same(tl, jl, "labels")


# (rank cap, tab cap, edge fill): the tiny batch's tiles hold up to 129
# target segments at fill 1.0, so cap 136 keeps the capped W = V aux and
# the bench preset's cap 64 falls back to the legacy W = K aux
SORT_CASES = [
    pytest.param(64, 64, 1.0, id="bench-flags-cap-violated"),
    pytest.param(136, 64, 1.0, id="cap-holds"),
    pytest.param(0, 0, 1.0, id="no-caps"),
    pytest.param(0, 64, 0.5, id="half-filled"),
]


@pytest.mark.parametrize("rank_cap,tab_cap,fill", SORT_CASES)
def test_sort_batch_forward_fields_bit_identical(flagships, rank_cap,
                                                 tab_cap, fill):
    jf, tf = flagships
    batch, _ = synth_flagship_batch(tf, 1, edge_fill=fill)
    se = sort_batch(batch, tf.layout, tf.em, tgt_rank_cap=rank_cap,
                    tab_cap=tab_cap)
    jse = jax_sort(batch, jf.layout, jf.em, native=False,
                   tgt_rank_cap=rank_cap, tab_cap=tab_cap)
    for f in FORWARD_FIELDS:
        _same(getattr(se, f), getattr(jse, f), f)
    for f in ("loc", "blk", "ptr2", "live_key"):
        _same(getattr(se.pseg_tgt, f), getattr(jse.pseg_tgt, f), f"pseg.{f}")
    assert (se.pseg_tgt.w, se.pseg_tgt.v) == (jse.pseg_tgt.w, jse.pseg_tgt.v)
    if rank_cap == 136:
        assert se.pseg_tgt.w == se.pseg_tgt.v == 136
    else:
        assert se.pseg_tgt.w == PK and se.pseg_tgt.v == 0
    assert (se.tab_sel is not None) == bool(tab_cap)


# every SortedEdges field only the backward reads
BACKWARD_FIELDS = (
    "perm_src", "seg_ptr_src", "perm_tab", "seg_ptr_tab", "tgt_src_order",
    "tgt_tab_order", "tl_src", "live_idx_src", "seg_ptr2_src", "tl_tab",
    "live_idx_tab", "seg_ptr2_tab",
)
BACKWARD_AUX = ("pseg_src", "pseg_tab", "ptab_src")


def _same_backward_aux(se, jse):
    for f in BACKWARD_FIELDS:
        _same(getattr(se, f), getattr(jse, f), f)
    for name in BACKWARD_AUX:
        a, ja = getattr(se, name), getattr(jse, name)
        assert (a is None) == (ja is None), name
        if a is None:
            continue
        for f in ("loc", "blk", "ptr2", "live_key"):
            _same(getattr(a, f), getattr(ja, f), f"{name}.{f}")
        assert (a.w, a.v) == (ja.w, ja.v), name
        assert a.window == (name == "ptab_src")


@pytest.mark.parametrize("rank_cap,tab_cap,fill", SORT_CASES)
def test_sort_batch_backward_fields_bit_identical(flagships, rank_cap,
                                                  tab_cap, fill):
    """The tiny preset: a tile spans more than two of its small blocks, so
    neither package builds the tab-window aux."""
    jf, tf = flagships
    batch, _ = synth_flagship_batch(tf, 1, edge_fill=fill)
    se = sort_batch(batch, tf.layout, tf.em, tgt_rank_cap=rank_cap,
                    tab_cap=tab_cap)
    jse = jax_sort(batch, jf.layout, jf.em, native=False,
                   tgt_rank_cap=rank_cap, tab_cap=tab_cap)
    _same_backward_aux(se, jse)
    assert se.ptab_src is None
    # a serving sort leaves the backward's aux out and nothing else
    fwd = sort_batch(batch, tf.layout, tf.em, tgt_rank_cap=rank_cap,
                     tab_cap=tab_cap, with_backward=False)
    for f in BACKWARD_FIELDS + BACKWARD_AUX:
        assert getattr(fwd, f) is None, f
    for f in FORWARD_FIELDS:
        _same(getattr(fwd, f), getattr(se, f), f)


def two_type_layouts():
    """(JAX layout, port layout) whose blocks all exceed the kernel tile
    (node cap 512, edge cap 1024), so the tab-window aux builds."""
    from pyhgt_tpu.graph import schema as jschema
    from pyhgt_tpu.sampling.batch import BatchLayout as JaxLayout
    from pyhgt_tpu_torch.graph import schema as tschema
    from pyhgt_tpu_torch.sampling.batch import BatchLayout

    def build(mod, layout_cls):
        schema = mod.GraphSchema(
            node_types=("paper", "author"),
            metas=(mod.MetaRelation("paper", "author", "AP_write"),
                   mod.MetaRelation("author", "paper", "rev_AP_write"),
                   mod.MetaRelation("paper", "paper", "PP_cite")))
        return layout_cls(schema=schema, pad=mod.PadSpec(
            node_cap=512, default_edge_cap=1024))
    return build(jschema, JaxLayout), build(tschema, BatchLayout)


@pytest.mark.parametrize("tab_cap", [0, 64, 8],
                         ids=["uncompacted", "tab-cap-64", "tab-cap-violated"])
def test_tab_window_aux_bit_identical(tab_cap):
    from pyhgt_tpu_torch.utils.synth import synth_batch

    jl, tl = two_type_layouts()
    batch = synth_batch(tl, np.random.default_rng(9), din=16, node_fill=0.9,
                        edge_fill=0.9)
    # dt is uniform over the 240 slots: draw it from 40 so that cap 64 holds
    batch.edge_dt[:] = 100 + batch.edge_dt % 40
    se = sort_batch(batch, tl, tab_cap=tab_cap)
    jse = jax_sort(batch, jl, native=False, tab_cap=tab_cap)
    for f in FORWARD_FIELDS:
        _same(getattr(se, f), getattr(jse, f), f)
    _same_backward_aux(se, jse)
    compact = tab_cap == 64
    assert (se.tab_sel is not None) == compact
    width = 64 if compact else 240
    assert se.ptab_src is not None
    assert se.ptab_src.w == se.ptab_src.v == width
    assert se.ptab_src.num_blocks == len(tl.blocks)
    assert se.seg_ptr_tab.shape[0] == len(tl.blocks) * width + 1


def test_sorted_edges_to_device_dtypes(flagships):
    import torch

    _, tf = flagships
    batch, _ = synth_flagship_batch(tf, 0)
    d = tf.sort(batch).to("cpu")
    assert d.gidx.dtype == torch.int32 and d.edge_mask.dtype == torch.bool
    assert d.rel_onehot.dtype == torch.float32
    assert d.pseg_tgt.loc.dtype == d.pseg_tgt.blk.dtype == torch.int32
    assert d.pseg_tgt.ptr2.dtype == torch.int64
    assert d.perm_src.dtype == d.tl_tab.dtype == torch.int32
    assert d.pseg_src.rows_checked and d.pseg_tab.rows_checked
    # a view already on the device moves as it is
    again = d.to("cpu")
    assert again.pseg_src.rows_checked
    assert torch.equal(again.perm_tab, d.perm_tab)
