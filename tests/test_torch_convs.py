"""The port's convs against the JAX package's: ``GNN`` over each of
``hgt``, ``dense_hgt``, ``gcn``, ``gat``, ``rgcn``, ``han`` and ``hetgnn``.

Layout of ``tests/test_models.py`` (3 node types, 5 relations and the self
blocks, node cap 16, edge cap 32), a ``synth_batch`` from a seed with a
quarter of the nodes and edges padding (masked edges point at node 0). Two
layers, n_hid 16, 4 heads, both norms on, f32, eval mode. The port's
seeded weights, moved off their initial constants by seeded noise (so
biases, gates and norms count), go to the JAX ``GNN`` through
``convert.named_to_flax``. The loss is ``sum(out * tgt)`` for a seeded
``tgt``.

Tolerances, of the compared tensor's largest magnitude, on both edge
paths: 1e-5 on outputs and 1e-4 on gradients (the packages sum the same
f32 terms in other orders; seen: at most 1.3e-6 and 6.5e-6).
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from pyhgt_tpu.graph.schema import (
    GraphSchema as JaxSchema,
    MetaRelation as JaxMeta,
    PadSpec as JaxPad,
)
from pyhgt_tpu.models import GNN as JaxGNN
from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JaxEdgeMeta
from pyhgt_tpu.sampling.batch import BatchLayout as JaxLayout
from pyhgt_tpu.sampling.sorted_batch import sort_batch as jax_sort
from pyhgt_tpu_torch.convert import flax_to_state_dict, named_to_flax
from pyhgt_tpu_torch.graph.schema import GraphSchema, MetaRelation, PadSpec
from pyhgt_tpu_torch.models.conv import CONV_NAMES, general_conv
from pyhgt_tpu_torch.models.model import GNN
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.sampling.batch import BatchLayout
from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch
from pyhgt_tpu_torch.utils.synth import synth_batch

METAS = (("paper", "author", "AP_write"), ("author", "paper", "rev_AP_write"),
         ("venue", "paper", "PV_in"), ("paper", "venue", "rev_PV_in"),
         ("paper", "paper", "PP_cite"))
TYPES = ("paper", "author", "venue")
DIN, N_HID, HEADS, LAYERS = 12, 16, 4, 2
TOL = (1e-5, 1e-4)      # outputs, gradients


def _layouts():
    port = BatchLayout(
        schema=GraphSchema(node_types=TYPES,
                           metas=tuple(MetaRelation(*m) for m in METAS)),
        pad=PadSpec(node_cap=16, default_edge_cap=32))
    jax_l = JaxLayout(
        schema=JaxSchema(node_types=TYPES,
                         metas=tuple(JaxMeta(*m) for m in METAS)),
        pad=JaxPad(node_cap=16, default_edge_cap=32))
    return port, jax_l


@pytest.fixture(scope="module")
def env():
    layout, jlayout = _layouts()
    batch = synth_batch(layout, np.random.default_rng(3), din=DIN,
                        node_fill=0.75, edge_fill=0.75)
    em = EdgeStaticMeta.from_layout(layout)
    tgt = np.random.default_rng(4).normal(
        size=(layout.num_types, layout.node_cap, N_HID)).astype(np.float32)
    return dict(layout=layout, jlayout=jlayout, batch=batch, em=em,
                jem=JaxEdgeMeta.from_layout(jlayout), tgt=tgt,
                se=sort_batch(batch, layout, em),
                jse=jax_sort(batch, jlayout, JaxEdgeMeta.from_layout(jlayout)))


def _gnn(layout, conv_name, edge_impl, seed=0):
    """The port's GNN with its seeded weights moved by seeded noise."""
    gnn = GNN(DIN, N_HID, layout.num_types, layout.schema.num_relations,
              HEADS, LAYERS, generator=torch.Generator().manual_seed(seed),
              dropout=0.0, conv_name=conv_name, prev_norm=True,
              last_norm=True, edge_impl=edge_impl)
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for p in gnn.parameters():
            p.add_(torch.from_numpy(
                rng.normal(scale=0.1, size=p.shape).astype(np.float32)))
    return gnn.eval()


def _holder(gnn):
    """``gnn`` under the name ``gnn``, as the composite models hold it (the
    layout ``convert`` maps)."""
    m = nn.Module()
    m.gnn = gnn
    return m


def _edges(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in (
        batch.edge_src, batch.edge_tgt, batch.edge_dt, batch.edge_mask))


def forward(gnn, env, batch, se=None):
    return gnn(torch.from_numpy(batch.node_feat),
               torch.from_numpy(batch.node_mask), se, env["em"].to("cpu"),
               edges=_edges(batch))


def run_port(gnn, env, se=None):
    """Output and named gradients of ``sum(out * tgt)``."""
    gnn.zero_grad()
    out = forward(gnn, env, env["batch"], se)
    (out * torch.from_numpy(env["tgt"])).sum().backward()
    return out.detach().numpy(), {
        f"gnn.{k}": p.grad.numpy() for k, p in gnn.named_parameters()}


def run_jax(gnn, env, conv_name, edge_impl):
    """The JAX GNN on the port's weights: output and gradients, the latter
    under the port's names."""
    b = env["batch"]
    params = named_to_flax(dict(_holder(gnn).named_parameters()))
    jparams = jax.tree_util.tree_map(jnp.asarray, params["params"]["gnn"])
    model = JaxGNN(in_dim=DIN, n_hid=N_HID,
                   num_types=env["layout"].num_types,
                   num_relations=env["layout"].schema.num_relations,
                   n_heads=HEADS, n_layers=LAYERS, dropout=0.0,
                   conv_name=conv_name, prev_norm=True, last_norm=True,
                   edge_impl=edge_impl)
    args = tuple(jnp.asarray(a) for a in (
        b.node_feat, b.edge_src, b.edge_tgt, b.edge_dt, b.edge_mask,
        b.node_mask))
    se = env["jse"] if edge_impl == "sorted" else None

    def loss(p):
        out = model.apply({"params": p}, *args, env["jem"], se=se)
        return jnp.sum(out * env["tgt"]), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)
    grads = flax_to_state_dict({"gnn": jax.tree_util.tree_map(np.asarray, g)})
    return np.asarray(out), {k: v.numpy() for k, v in grads.items()}


def close(got, want, tol, what):
    scale = float(np.max(np.abs(want))) + 1e-12
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def check(port, ref, tols):
    (out, grads), (rout, rgrads) = port, ref
    close(out, rout, tols[0], "outputs")
    assert set(grads) == set(rgrads)
    for k in sorted(grads):
        close(grads[k], rgrads[k], tols[1], k)


@pytest.mark.parametrize("conv_name", CONV_NAMES)
def test_segment_path_matches_jax(env, conv_name):
    """Outputs and gradients of every conv on the segment path against the
    JAX ``GNN(edge_impl="segment")``."""
    gnn = _gnn(env["layout"], conv_name, "segment")
    port = run_port(gnn, env)
    assert np.isfinite(port[0]).all()
    check(port, run_jax(gnn, env, conv_name, "segment"), TOL)


@pytest.mark.parametrize("conv_name", ["hgt", "dense_hgt"])
def test_sorted_path_matches_jax_and_segment(env, conv_name):
    """HGT and DenseHGT on the sorted path against the JAX sorted path and
    against the port's own segment path on the same weights (the
    counterpart of ``tests/test_sorted_ops.py``'s sorted-vs-segment
    test)."""
    gnn = _gnn(env["layout"], conv_name, "sorted")
    port = run_port(gnn, env, se=env["se"].to(torch.device("cpu")))
    check(port, run_jax(gnn, env, conv_name, "sorted"), TOL)
    seg = _gnn(env["layout"], conv_name, "segment")
    seg.load_state_dict(gnn.state_dict())
    check(port, run_port(seg, env), TOL)


@pytest.mark.parametrize("conv_name", CONV_NAMES)
def test_padding_does_not_leak(env, conv_name):
    """The valid rows' outputs do not move when the masked edges point
    elsewhere (other nodes, other time gaps) and the padded nodes carry
    other features."""
    gnn = _gnn(env["layout"], conv_name, "segment")
    b = env["batch"]
    rng = np.random.default_rng(7)
    moved = type(b)(**{k: np.array(v) for k, v in vars(b).items()})
    off = ~moved.edge_mask
    n_nodes = moved.node_mask.size
    moved.edge_src[off] = rng.integers(0, n_nodes, off.sum())
    moved.edge_tgt[off] = rng.integers(0, n_nodes, off.sum())
    moved.edge_dt[off] = rng.integers(0, 240, off.sum())
    pad = ~moved.node_mask
    moved.node_feat[pad] = rng.normal(size=(pad.sum(), DIN))
    with torch.no_grad():
        a = forward(gnn, env, b).numpy()
        c = forward(gnn, env, moved).numpy()
    live = b.node_mask
    np.testing.assert_allclose(c[live], a[live], rtol=0, atol=1e-6)
    assert not c[~live].any()


def test_unknown_conv_name_raises():
    with pytest.raises(NotImplementedError, match="conv_name 'sage'"):
        general_conv("sage", 8, 8, 2, 3, 2,
                     generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("conv_name", CONV_NAMES)
def test_convert_round_trips_the_flax_tree(env, conv_name):
    """The port's names carry into the JAX package's tree exactly (every
    leaf, shape for shape, as flax builds it) and back."""
    gnn = _gnn(env["layout"], conv_name, "segment")
    named = dict(_holder(gnn).named_parameters())
    tree = named_to_flax(named)
    b = env["batch"]
    model = JaxGNN(in_dim=DIN, n_hid=N_HID,
                   num_types=env["layout"].num_types,
                   num_relations=env["layout"].schema.num_relations,
                   n_heads=HEADS, n_layers=LAYERS, conv_name=conv_name,
                   prev_norm=True, last_norm=True)
    shapes = jax.eval_shape(lambda k: model.init(
        k, *(jnp.asarray(a) for a in (
            b.node_feat, b.edge_src, b.edge_tgt, b.edge_dt, b.edge_mask,
            b.node_mask)), env["jem"]), jax.random.key(0))
    want = jax.tree_util.tree_map(lambda s: s.shape, shapes["params"])
    got = jax.tree_util.tree_map(np.shape, tree["params"]["gnn"])
    assert got == jax.tree_util.tree_map(tuple, want,
                                         is_leaf=lambda x: isinstance(x, tuple))
    back = flax_to_state_dict(tree)
    assert set(back) == set(named)
    for k, t in named.items():
        assert torch.equal(back[k], t.detach()), k
