"""The port's edge partition against the JAX package's.

``partition_sorted`` is held against the JAX package's leaf for leaf on
every shard (the plain split, per-shard caps, the all-or-none cap
fallback, the numpy and the C++ pack, the refusal of a compacted batch), on
``tests/test_edge_partition.py``'s small layout. The partitioned conv runs
at gp = 2 in one world of two gloo ranks on the CPU (spawned once for the
module) and is held against the JAX package's single-device
``hgt_conv_core_sorted`` (plain path), forward and gradients, with and
without RTE, under the tilemax softmax unguarded and ``"auto"``, with the
per-shard caps, and with ``gp_overlap``'s ring against the all-reduce. The
same world checks ``ring_allreduce`` against ``all_reduce`` (sum and max,
7 rows over 2 ranks). Tolerances: f32 outputs within 1e-5 of their scale
(max |out|), gradients within 1e-4 of each tensor's scale; the two
packages and the two ranks sum in other orders.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.graph.schema import GraphSchema, MetaRelation, PadSpec
from pyhgt_tpu_torch.ops import sorted_hgt
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.ops.pallas_seg import PallasSegAux
from pyhgt_tpu_torch.ops.rte import rte_sin_table
from pyhgt_tpu_torch.parallel import edge_partition as ep
from pyhgt_tpu_torch.parallel import mesh as pmesh
from pyhgt_tpu_torch.parallel.distributed import spawn
from pyhgt_tpu_torch.sampling.batch import BatchLayout
from pyhgt_tpu_torch.sampling.sorted_batch import SortedEdges, sort_batch
from pyhgt_tpu_torch.utils.synth import synth_batch

D, H, PK = 24, 4, 256
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
# (use_rte, softmax_tilemax, gp_overlap, (tgt_rank_cap, tab_cap))
CONV_CASES = {
    "rte": (True, False, False, (0, 0)),
    "no-rte": (False, False, False, (0, 0)),
    "tilemax-auto": (True, "auto", False, (0, 0)),
    "tilemax-caps": (True, True, False, (72, 64)),
    "ring": (True, False, True, (0, 0)),
}
PARAM_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "rel_pri", "rel_att",
               "rel_msg")


def small_env(pk=PK):
    """``tests/test_edge_partition.py``'s layout and batch, port-built."""
    schema = GraphSchema(
        node_types=("paper", "author"),
        metas=(MetaRelation("paper", "author", "AP_write"),
               MetaRelation("author", "paper", "rev_AP_write"),
               MetaRelation("paper", "paper", "PP_cite")))
    layout = BatchLayout(schema=schema,
                         pad=PadSpec(node_cap=32, default_edge_cap=64))
    em = EdgeStaticMeta.from_layout(layout)
    batch = synth_batch(layout, np.random.default_rng(3), din=D,
                        node_fill=0.8, edge_fill=0.7)
    return layout, em, batch, sort_batch(batch, layout, em, pk=pk)


def params(T, R):
    """``tests/test_sorted_ops.py``'s ``_params`` draw, as numpy."""
    rng = np.random.default_rng(0)
    dk = D // H
    return {
        "wq": rng.normal(size=(T, D, D)).astype(np.float32) * 0.3,
        "bq": rng.normal(size=(T, D)).astype(np.float32) * 0.1,
        "wk": rng.normal(size=(T, D, D)).astype(np.float32) * 0.3,
        "bk": rng.normal(size=(T, D)).astype(np.float32) * 0.1,
        "wv": rng.normal(size=(T, D, D)).astype(np.float32) * 0.3,
        "bv": rng.normal(size=(T, D)).astype(np.float32) * 0.1,
        "rel_pri": (rng.normal(size=(R, H)) + 1).astype(np.float32),
        "rel_att": rng.normal(size=(R, H, dk, dk)).astype(np.float32) * 0.3,
        "rel_msg": rng.normal(size=(R, H, dk, dk)).astype(np.float32) * 0.3,
    }


def cotangent(layout):
    return np.random.default_rng(9).normal(
        size=(layout.num_types, layout.node_cap, D)).astype(np.float32)


def partition(layout, se, **kw):
    return ep.partition_sorted(
        se, 2, num_blocks=len(layout.blocks), node_cap=layout.node_cap,
        num_nodes_flat=layout.num_types * layout.node_cap, pk=PK, **kw)


# ------------------------------------------------------------ the partition
def _jax_partition(layout_np, batch, **kw):
    from pyhgt_tpu.graph.schema import GraphSchema as JS, MetaRelation as JM
    from pyhgt_tpu.graph.schema import PadSpec as JP
    from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JE
    from pyhgt_tpu.parallel.edge_partition import partition_sorted
    from pyhgt_tpu.sampling.batch import BatchLayout as JL
    from pyhgt_tpu.sampling.sorted_batch import sort_batch as jsort

    schema = JS(node_types=("paper", "author"),
                metas=(JM("paper", "author", "AP_write"),
                       JM("author", "paper", "rev_AP_write"),
                       JM("paper", "paper", "PP_cite")))
    layout = JL(schema=schema, pad=JP(node_cap=32, default_edge_cap=64))
    em = JE.from_layout(layout)
    se = jsort(batch, layout, em, pk=PK)
    return partition_sorted(
        se, 2, num_blocks=len(layout.blocks), node_cap=layout.node_cap,
        num_nodes_flat=layout.num_types * layout.node_cap, pk=PK, **kw)


def _same_leaf(a, b, what):
    assert (a is None) == (b is None), what
    if a is None:
        return
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(a, b, what)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)


def _same_shard(se: SortedEdges, jse, what):
    for f in dataclasses.fields(se):
        a, ja = getattr(se, f.name), getattr(jse, f.name, None)
        name = f"{what}.{f.name}"
        if isinstance(a, PallasSegAux):
            assert ja is not None, name
            for g in ("loc", "blk", "ptr2", "live_key"):
                _same_leaf(getattr(a, g), getattr(ja, g), f"{name}.{g}")
            assert (a.w, a.v) == (ja.w, ja.v), name
        elif isinstance(a, int):
            assert a == int(ja or 0), name
        else:
            _same_leaf(a, ja, name)


PARTITION_CASES = {
    "plain": dict(),
    # both caps engage on every shard
    "caps": dict(tgt_rank_cap=72, tab_cap=64),
    # rank cap 8 holds on no shard: legacy width everywhere, tab kept
    "fallback": dict(tgt_rank_cap=8, tab_cap=64),
    # a tab cap the pack never applies (not a multiple of 8)
    "tab-cap-inapplicable": dict(tgt_rank_cap=72, tab_cap=60),
}


@pytest.mark.parametrize("case", list(PARTITION_CASES))
def test_partition_matches_jax_leaf_for_leaf(case):
    import jax

    kw = PARTITION_CASES[case]
    layout, em, batch, se = small_env()
    pe = partition(layout, se, **kw)
    jpe = _jax_partition(None, batch, **kw)
    assert len(pe.shards) == 2
    for i, shard in enumerate(pe.shards):
        jshard = jax.tree_util.tree_map(lambda a, i=i: np.asarray(a)[i],
                                        jpe.se)
        _same_shard(shard, jshard, f"{case} shard {i}")
        assert shard.edge_tgt.shape[0] % PK == 0
    caps = [(s.pseg_tgt.v, s.tab_sel is not None) for s in pe.shards]
    assert caps == [{"plain": (0, False), "caps": (72, True),
                     "fallback": (0, True),
                     "tab-cap-inapplicable": (72, False)}[case]] * 2


def test_partition_numpy_and_native_packs_agree(monkeypatch):
    """The numpy pack and the C++ one reach the same ``_pack_sorted``,
    bit-identical shards (caps on)."""
    from pyhgt_tpu_torch.sampling.sorted_batch import _native_batch

    if _native_batch() is None:
        pytest.skip("the C++ batch prep does not build here")
    layout, em, batch, se = small_env()
    native = partition(layout, se, tgt_rank_cap=72, tab_cap=64)
    monkeypatch.setattr(ep, "_native_batch", lambda: None)
    plain = partition(layout, se, tgt_rank_cap=72, tab_cap=64)
    for i, (a, b) in enumerate(zip(native.shards, plain.shards)):
        _same_shard(a, b, f"shard {i}")


def test_partition_refuses_compacted_batch():
    from pyhgt_tpu_torch.flagship import build_flagship, synth_flagship_batch

    fl = build_flagship("tiny", device="cpu", tab_cap=64)
    batch, _ = synth_flagship_batch(fl, seed=0)
    se = fl.sort(batch)
    assert se.tab_sel is not None
    with pytest.raises(ValueError, match="UNCOMPACTED"):
        fl.partition(se, 2)
    # the gp flagship sorts uncompacted and partitions with the caps
    fl_gp = build_flagship("tiny", device="cpu", tab_cap=64,
                           graph_axis="graph")
    se_gp = fl_gp.sort(batch)
    assert se_gp.tab_sel is None and se_gp.src_cut == 0
    pe = fl_gp.partition(se_gp, 2)
    assert all(s.tab_sel is not None for s in pe.shards)


# ------------------------------------------------- the conv across 2 ranks
def _torch_params(p):
    return {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}


def _conv_world(rank, world):
    """Every conv case on this rank's shard, and the ring checks."""
    layout, em, batch, se = small_env()
    em_t = em.to("cpu")
    mesh = pmesh.make_mesh(n_data=1, n_graph=world)
    group = mesh.group(pmesh.GRAPH_AXIS)
    g_out = torch.tensor(cotangent(layout))
    p_np = params(layout.num_types, layout.schema.num_relations)
    out = {}
    for name, (use_rte, tilemax, overlap, caps) in CONV_CASES.items():
        pe = partition(layout, se, tgt_rank_cap=caps[0], tab_cap=caps[1])
        shard = pe.local(mesh.index(pmesh.GRAPH_AXIS), group).to("cpu")
        p = _torch_params(p_np)
        x = torch.tensor(np.asarray(batch.node_feat), requires_grad=True)
        rte = torch.tensor(rte_sin_table(D)) if use_rte else None
        y = ep.hgt_conv_core_partitioned(
            x, shard, em_t, n_heads=H, rte_vec=rte, overlap=overlap,
            softmax_tilemax=tilemax, **p)
        (y * g_out).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy(),
                     {k: t.grad.numpy() for k, t in p.items()})
    rows = torch.arange(7 * 3, dtype=torch.float32).reshape(7, 3)
    xr = torch.sin(rows * (rank + 1))
    ring = {op: (sorted_hgt.ring_allreduce(xr, group, op).numpy(),
                 pmesh.all_reduce(xr.clone(), group, op).numpy())
            for op in ("sum", "max")}
    return out, ring


@pytest.fixture(scope="module")
def world():
    return spawn(_conv_world, 2)


def _jax_reference(use_rte, tilemax):
    import jax
    import jax.numpy as jnp

    from pyhgt_tpu.graph.schema import GraphSchema as JS, MetaRelation as JM
    from pyhgt_tpu.graph.schema import PadSpec as JP
    from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JE
    from pyhgt_tpu.ops.rte import rte_sin_table as jrte
    from pyhgt_tpu.ops.sorted_hgt import hgt_conv_core_sorted
    from pyhgt_tpu.sampling.batch import BatchLayout as JL
    from pyhgt_tpu.sampling.sorted_batch import sort_batch as jsort

    schema = JS(node_types=("paper", "author"),
                metas=(JM("paper", "author", "AP_write"),
                       JM("author", "paper", "rev_AP_write"),
                       JM("paper", "paper", "PP_cite")))
    layout = JL(schema=schema, pad=JP(node_cap=32, default_edge_cap=64))
    em = JE.from_layout(layout)
    _, _, batch, _ = small_env()
    se = jsort(batch, layout, em, pk=PK)
    rte = jnp.asarray(jrte(D)) if use_rte else None
    g_out = jnp.asarray(cotangent(layout))

    def loss(p, x):
        y = hgt_conv_core_sorted(x, se, em, n_heads=H, rte_vec=rte,
                                 softmax_tilemax=tilemax, **p)
        return jnp.sum(y * g_out), y

    p = {k: jnp.asarray(v) for k, v in
         params(layout.num_types, layout.schema.num_relations).items()}
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(batch.node_feat))
    return (np.asarray(y), np.asarray(gx),
            {k: np.asarray(v) for k, v in gp.items()})


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_partitioned_conv_matches_jax_single_device(world, case):
    use_rte, tilemax, _, _ = CONV_CASES[case]
    y_ref, gx_ref, gp_ref = _jax_reference(use_rte, tilemax)
    (out0, _), (out1, _) = world
    for rank, out in enumerate((out0, out1)):
        y, gx, gp = out[case]
        _close(y, y_ref, OUT_TOL, f"{case} rank {rank} out")
        _close(gx, gx_ref, GRAD_TOL, f"{case} rank {rank} d/dx")
        assert set(gp) == set(PARAM_NAMES)
        for k in PARAM_NAMES:
            _close(gp[k], gp_ref[k], GRAD_TOL, f"{case} rank {rank} d/d{k}")
    # every rank ends the backward with the same gradients
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(out0[case][2][k], out1[case][2][k], k)
    if case == "ring":
        # gp_overlap's ring against the all-reduce of the "rte" case
        for a, b in zip(out0["ring"][:2], out0["rte"][:2]):
            _close(a, b, OUT_TOL, "ring vs all_reduce")


def test_ring_allreduce_matches_all_reduce(world):
    want_sum = sum(np.sin(np.arange(21, dtype=np.float32).reshape(7, 3)
                          * (r + 1)) for r in range(2))
    for _, ring in world:
        for op in ("sum", "max"):
            got, ref = ring[op]
            assert got.shape == (7, 3)
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ring["sum"][0], want_sum, rtol=1e-6,
                                   atol=1e-6)
