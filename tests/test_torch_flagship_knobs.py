"""The flagship under its non-default edge-stage knobs against the JAX
package's, on the tiny preset with converted weights: the loss and every
parameter gradient under ``edge_bwd="slab"`` + ``softmax_pallas=True`` (the
JAX side reaches ``live_partials_slab`` and ``segment_softmax_partials`` in
interpret mode; the port runs their plain versions), the knobs' plumbing
from ``FlagshipConfig`` and the port bench's flags down to the edge stage,
and ``HGTConv.attention_weights``."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyhgt_tpu.flagship import build_flagship as jax_build
from pyhgt_tpu_torch import bench
from pyhgt_tpu_torch.convert import flax_to_state_dict, load_flax_params
from pyhgt_tpu_torch.flagship import (
    PRESETS, build_flagship, synth_flagship_batch,
)
from pyhgt_tpu_torch.ops import sorted_hgt

KNOBS = dict(dropout=0.0, seg_pallas=True, edge_bwd="slab",
             softmax_pallas=True)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(sorted_hgt, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return real(*a, **kw)
    monkeypatch.setattr(sorted_hgt, name, wrapped)
    return calls


def test_slab_and_softmax_kernel_loss_and_gradients_match_jax(monkeypatch):
    jf = jax_build("tiny", **KNOBS)
    tf = build_flagship("tiny", device="cpu", **KNOBS)
    batch, labels = synth_flagship_batch(tf, 0)
    jse = jf.sort(batch)
    params = jax.jit(lambda key: jf.model.init(
        key, *jf.batch_args(batch), jf.em, se=jse))(jax.random.PRNGKey(0))
    jloss, jgrads = jax.jit(jax.value_and_grad(jf.loss_fn_single()))(
        params, jax.random.PRNGKey(1), *jf.batch_args(batch), jse,
        jnp.asarray(labels))
    load_flax_params(tf.model, jax.tree_util.tree_map(np.asarray, params))

    slab = _spy(monkeypatch, "live_partials_slab")
    softmax = _spy(monkeypatch, "segment_softmax_partials")
    pair = _spy(monkeypatch, "live_partials_pair")
    loss = tf.loss(batch, tf.sort(batch), labels)
    loss.backward()
    n_layers = tf.cfg.n_layers
    # the tiny layout has no tab-window aux: the slab also sums the tab
    # grouping (two launches per layer), and the pair never runs
    assert (len(slab), len(softmax), len(pair)) == (2 * n_layers, n_layers, 0)

    # f32 on both sides; sums run in another order (see
    # tests/test_torch_edge_bwd.py): 3e-4 of each tensor's scale
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tf.model.named_parameters()}
    assert got.keys() == want.keys()
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        assert got[name] is not None and torch.isfinite(got[name]).all(), name
        scale = max(w.abs().max().item(), 1e-3 * top)
        err = (got[name] - w).abs().max().item()
        assert err <= 3e-4 * scale, (name, err, scale)


def test_config_carries_the_jax_package_knobs():
    from pyhgt_tpu.flagship import PRESETS as JAX_PRESETS

    names = ("edge_bwd", "softmax_pallas", "softmax_tilemax", "seg_tile",
             "seg_w", "src_rank_cap", "src_split_cap", "seg_rank_cap",
             "tab_cap", "seg_pallas", "edge_bf16", "save_kv")
    for preset in ("tiny", "bench"):
        for name in names:
            assert (getattr(PRESETS[preset], name)
                    == getattr(JAX_PRESETS[preset], name)), (preset, name)
    tf = build_flagship("tiny", device="cpu", edge_bwd="src_direct",
                        softmax_tilemax="auto", softmax_pallas=True)
    for conv in tf.model.gnn.convs:
        assert (conv.edge_bwd, conv.softmax_tilemax, conv.softmax_pallas) == (
            "src_direct", "auto", True)
    with pytest.raises(ValueError, match="edge_bwd"):
        build_flagship("tiny", device="cpu", edge_bwd="scatter")
    with pytest.raises(ValueError, match="softmax_tilemax"):
        build_flagship("tiny", device="cpu", softmax_tilemax="maybe")


@pytest.mark.parametrize("flags,kernel", [
    (["--edge_bwd", "slab", "--seg_pallas"], "live_partials_slab"),
    (["--edge_bwd", "recompute", "--seg_pallas", "--edge_bf16"],
     "live_partials_pair"),
    (["--softmax_pallas", "--no-seg_pallas", "--no-edge_bf16"],
     "segment_softmax_partials"),
], ids=["slab", "recompute-bf16", "softmax_pallas"])
def test_bench_flags_reach_the_edge_stage(flags, kernel, monkeypatch, capsys):
    calls = _spy(monkeypatch, kernel)
    assert bench.main(["--preset", "tiny", "--device", "cpu", "--steps", "1",
                       "--warmup", "0", *flags]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "hgt_train_edges_per_s_cpu" and out["value"] > 0
    assert calls
    with pytest.raises(SystemExit):
        bench.main(["--edge_bwd", "scatter"])


def test_attention_weights_are_the_forward_s():
    tf = build_flagship("tiny", device="cpu", seg_pallas=True)
    batch, _ = synth_flagship_batch(tf, 2)
    b, se, _ = tf.to_device(batch, tf.sort(batch, with_backward=False))
    conv = tf.model.gnn.convs[0]
    x = torch.randn(tf.layout.num_types, tf.cfg.node_cap, tf.cfg.n_hid,
                    generator=torch.Generator().manual_seed(0))
    w = conv.attention_weights(x, se, tf.em_dev)
    assert w.shape == (se.edge_tgt.shape[0], tf.cfg.n_heads)
    assert not w.requires_grad and torch.isfinite(w).all()
    assert (w[~se.edge_mask] == 0).all()
    sums = torch.zeros(tf.layout.num_types * tf.cfg.node_cap, tf.cfg.n_heads)
    sums.index_add_(0, se.edge_tgt.long()[se.edge_mask], w[se.edge_mask])
    has_edges = sums.sum(1) > 0
    torch.testing.assert_close(sums[has_edges],
                               torch.ones_like(sums[has_edges]),
                               rtol=0, atol=1e-5)
