"""The port's segment edge path against the JAX package's:
``segment_sum``, ``segment_max`` and ``segment_softmax``
(``pyhgt_tpu/ops/segment.py``) and ``hgt_conv_core``
(``pyhgt_tpu/ops/hgt.py``), on the same numpy inputs from a seed.

The segment primitives take ``[E]`` and ``[E, H]`` rows, with and without a
mask, over more segments than the ids reach (empty segments) and with a
segment whose rows are all masked; within 1e-6 of the result's largest
finite magnitude (both packages add f32 rows in their own order), the
infinities and ``NEG`` of empty segments equal. ``hgt_conv_core`` on the
layout of ``tests/test_torch_convs.py``, with and without RTE: ``aggr``
and ``w`` within 1e-5 of scale, the gradients of every weight bank and of
the RTE vectors for ``sum(aggr * tgt)`` within 1e-4 of scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyhgt_tpu.ops import segment as jseg
from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JaxMeta
from pyhgt_tpu.ops.hgt import hgt_conv_core as jax_core
from pyhgt_tpu_torch.ops import segment
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta, hgt_conv_core
from pyhgt_tpu_torch.ops.rte import rte_sin_table
from pyhgt_tpu_torch.utils.synth import synth_batch
from test_torch_convs import _layouts

E, N_SEG = 200, 40


def _case(shape, masked, seed):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(E,) + shape) * 3).astype(np.float32)
    # ids reach 30 of the 40 segments; segment 7 gets its rows all masked
    ids = rng.integers(0, 30, E).astype(np.int32)
    mask = rng.random(E) > 0.3 if masked else None
    if masked:
        mask[ids == 7] = False
    return data, ids, mask


def _same(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = float(np.max(np.abs(want[fin]))) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=tol * scale)


@pytest.mark.parametrize("fn", ["segment_sum", "segment_max",
                                "segment_softmax"])
@pytest.mark.parametrize("shape", [(), (4,)], ids=["E", "EH"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_segment_ops_match_jax(fn, shape, masked):
    data, ids, mask = _case(shape, masked, seed=len(shape) * 2 + masked)
    jmask = None if mask is None else jnp.asarray(mask)
    want = getattr(jseg, fn)(jnp.asarray(data), jnp.asarray(ids), N_SEG,
                             mask=jmask)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = getattr(segment, fn)(torch.from_numpy(data), torch.from_numpy(ids),
                               N_SEG, mask=tmask)
    assert got.shape == want.shape and got.dtype == torch.float32
    _same(got.numpy(), want, 1e-6)
    if fn == "segment_softmax" and masked:
        # masked rows weigh 0; a segment with no valid row all 0
        w = got.numpy()
        assert not w[~mask].any()
        assert not w[ids == 7].any()
    if fn == "segment_max" and masked:
        assert (got.numpy()[7] == segment.NEG).all()   # all rows masked
        assert np.isneginf(got.numpy()[35]).all()      # no row at all


def _core_inputs(use_rte):
    layout, _ = _layouts()
    batch = synth_batch(layout, np.random.default_rng(5), din=16,
                        node_fill=0.75, edge_fill=0.75)
    T, R = layout.num_types, layout.schema.num_relations
    H, D = 4, 16
    dk = D // H
    rng = np.random.default_rng(6)

    def w(*s, scale=0.3):
        return (rng.normal(size=s) * scale).astype(np.float32)

    params = dict(wq=w(T, 16, D), bq=w(T, D), wk=w(T, 16, D), bk=w(T, D),
                  wv=w(T, 16, D), bv=w(T, D), rel_pri=1 + w(R, H),
                  rel_att=w(R, H, dk, dk, scale=0.5),
                  rel_msg=w(R, H, dk, dk, scale=0.5))
    if use_rte:
        params["rte_vec"] = rte_sin_table(16) @ w(16, 16) + w(16)
    tgt = rng.normal(size=(T, layout.node_cap, D)).astype(np.float32)
    return layout, batch, params, tgt


@pytest.mark.parametrize("use_rte", [True, False], ids=["rte", "no-rte"])
def test_hgt_conv_core_matches_jax(use_rte):
    layout, batch, params, tgt = _core_inputs(use_rte)
    jlayout = _layouts()[1]
    arrays = (batch.edge_src, batch.edge_tgt, batch.edge_dt,
              batch.edge_mask)

    def jloss(p, x):
        aggr, w = jax_core(x, *(jnp.asarray(a) for a in arrays),
                           JaxMeta.from_layout(jlayout), n_heads=4, **p)
        return jnp.sum(aggr * tgt), (aggr, w)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (_, (jaggr, jw)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(batch.node_feat))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(batch.node_feat, requires_grad=True)
    em = EdgeStaticMeta.from_layout(layout).to("cpu")
    aggr, w = hgt_conv_core(x, *(torch.from_numpy(np.asarray(a))
                                 for a in arrays), em, n_heads=4, **tp)
    (aggr * torch.from_numpy(tgt)).sum().backward()

    _same(aggr.detach().numpy(), jaggr, 1e-5)
    _same(w.detach().numpy(), jw, 1e-5)
    assert w.dtype == torch.float32
    for k in params:
        _same(tp[k].grad.numpy(), jg[0][k], 1e-4)
    _same(x.grad.numpy(), jg[1], 1e-4)
