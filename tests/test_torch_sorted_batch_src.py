"""The port's host sort under the src caps and the tile overrides against the
JAX package's numpy path: ``sort_batch(native=False)`` with ``src_rank_cap``
(singleton-split aux), ``src_split_cap`` (two-region aux) and ``pk``/``pw``
must give bit-identical arrays, and ``None`` where a cap does not hold."""

import numpy as np
import pytest
import torch

from pyhgt_tpu.sampling.sorted_batch import sort_batch as jax_sort
from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch
from pyhgt_tpu_torch.ops.pallas_seg import PK
from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch
from pyhgt_tpu_torch.utils.synth import synth_batch
from test_torch_sorted_batch import (
    BACKWARD_FIELDS, FORWARD_FIELDS, _same, two_type_layouts,
)

AUX = ("pseg_tgt", "pseg_src", "pseg_tab", "ptab_src", "pseg_src_multi",
       "pseg_src_lo")
SRC_FIELDS = ("src_single_edges", "src_single_inv", "src_tail_ptr2")


def aligned_layouts():
    """(JAX layout, port layout) whose meta capacities sum to the kernel
    tile (3 x 128 = 384), so the static meta/self boundary in src order is
    tile-aligned and the two-region src aux can build."""
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
            node_cap=32, default_edge_cap=128))
    return build(jschema, JaxLayout), build(tschema, BatchLayout)


def _same_sort(se, jse):
    for f in FORWARD_FIELDS + BACKWARD_FIELDS + SRC_FIELDS:
        _same(getattr(se, f), getattr(jse, f), f)
    assert (se.src_cut, se.src_s1) == (jse.src_cut, jse.src_s1)
    for name in AUX:
        a, ja = getattr(se, name), getattr(jse, name)
        assert (a is None) == (ja is None), name
        if a is None:
            continue
        for f in ("loc", "blk", "ptr2", "live_key"):
            _same(getattr(a, f), getattr(ja, f), f"{name}.{f}")
        assert (a.w, a.v) == (ja.w, ja.v), name
        assert a.window == (name == "ptab_src")
        assert a.dead_rows == (name == "pseg_src_multi")


def _batch(tl, din=16):
    return synth_batch(tl, np.random.default_rng(5), din=din, node_fill=0.9,
                       edge_fill=0.8)


@pytest.mark.parametrize("cap,holds", [(128, True), (8, False)],
                         ids=["cap-holds", "cap-violated"])
def test_src_caps_bit_identical(cap, holds):
    jl, tl = aligned_layouts()
    batch = _batch(tl)
    kw = dict(src_rank_cap=cap, src_split_cap=cap)
    se, jse = sort_batch(batch, tl, **kw), jax_sort(batch, jl, native=False,
                                                    **kw)
    _same_sort(se, jse)
    assert (se.pseg_src_multi is not None) == holds
    assert (se.pseg_src_lo is not None) == holds
    if holds:
        assert se.pseg_src_multi.w == se.pseg_src_multi.v == cap
        assert (se.pseg_src_lo.w, se.pseg_src_lo.v) == (2 * cap, cap)
        assert (se.src_cut, se.src_s1) == (384, 3 * 32)
        assert (se.pseg_src_multi.loc == -1).any()
    else:
        assert (se.src_cut, se.src_s1) == (0, 0)
        assert se.src_single_edges is None and se.src_tail_ptr2 is None


def test_src_split_on_a_layout_with_a_tab_window():
    """Blocks larger than the tile: the two-region aux and the tab-window aux
    build together; the singleton-split aux does not (too many degree-1
    sources for its gather cap), in both packages."""
    jl, tl = two_type_layouts()
    batch = _batch(tl)
    kw = dict(src_rank_cap=256, src_split_cap=256, tab_cap=0)
    se, jse = sort_batch(batch, tl, **kw), jax_sort(batch, jl, native=False,
                                                    **kw)
    _same_sort(se, jse)
    assert se.pseg_src_lo is not None and se.ptab_src is not None
    assert se.pseg_src_multi is None
    assert se.src_cut == 3 * 1024 and se.src_s1 == 3 * 512


def test_misaligned_boundary_gives_no_split():
    """The tiny preset's meta capacities do not sum to a tile multiple."""
    tf = build_flagship("tiny", device="cpu")
    from pyhgt_tpu.flagship import build_flagship as jax_build

    jf = jax_build("tiny")
    batch, _ = synth_flagship_batch(tf, 1)
    kw = dict(src_rank_cap=64, src_split_cap=64)
    se = sort_batch(batch, tf.layout, tf.em, **kw)
    _same_sort(se, jax_sort(batch, jf.layout, jf.em, native=False, **kw))
    assert se.pseg_src_lo is None and se.src_cut == 0


@pytest.mark.parametrize("pk,pw", [(128, None), (128, 256), (256, None)],
                         ids=["pk128", "pk128-pw256", "pk256"])
def test_tile_overrides_bit_identical(pk, pw):
    jl, tl = aligned_layouts()
    batch = _batch(tl)
    kw = dict(pk=pk, pw=pw, tgt_rank_cap=64, tab_cap=64)
    se, jse = sort_batch(batch, tl, **kw), jax_sort(batch, jl, native=False,
                                                    **kw)
    _same_sort(se, jse)
    E = se.edge_tgt.shape[0]
    assert E % pk == 0 and E == -(-tl.num_edges // pk) * pk
    assert se.pseg_src.loc.shape == (E // pk, pk)
    assert se.pseg_src.w == (pw or pk)
    with pytest.raises(ValueError, match="reduction tile"):
        sort_batch(batch, tl, pk=192)


def test_flagship_sort_passes_the_knobs():
    jl, tl = aligned_layouts()
    tf = build_flagship("tiny", device="cpu", seg_tile=128, seg_w=256,
                        src_rank_cap=128, src_split_cap=128)
    tf.layout, tf.em = tl, None           # the aligned layout, its own meta
    se = tf.sort(_batch(tl))
    assert se.pseg_src.loc.shape[1] == 128 and se.pseg_src.w == 256
    assert se.pseg_src_multi is not None and se.pseg_src_lo is not None
    # a serving sort carries none of the backward's aux
    fwd = tf.sort(_batch(tl), with_backward=False)
    assert fwd.pseg_src_multi is None and fwd.pseg_src_lo is None
    assert fwd.src_cut == 0


def test_sorted_edges_to_device_moves_the_src_aux():
    _, tl = aligned_layouts()
    d = sort_batch(_batch(tl), tl, src_rank_cap=128, src_split_cap=128).to("cpu")
    assert isinstance(d.src_cut, int) and d.src_cut == 384
    assert d.src_single_edges.dtype == d.src_tail_ptr2.dtype == torch.int32
    assert d.pseg_src_multi.rows_checked and d.pseg_src_multi.dead_rows
    assert d.pseg_src_lo.rows_checked and not d.pseg_src_lo.dead_rows
    assert d.pseg_src_multi.loc.dtype == torch.int32
    assert PK == 384
