"""Every single-device route of the edge stage against the JAX package's.

One ``hgt_conv_core_sorted`` layer of each package takes the same weights
and inputs (numpy, seeded); the loss is ``sum(out * tgt)``. Outputs and the
gradients of the node features, every weight bank and the RTE vectors are
held against ``jax.value_and_grad``, whose Pallas kernels run in interpret
mode, for the routes beside the default one
(``tests/test_torch_edge_bwd.py`` holds that):

- the ``recompute``, ``src_direct`` and ``slab`` backward strategies, each on
  a layout with a tab-window aux (``two-type``) and on one without
  (``tiny``), where their fallbacks run;
- ``softmax_pallas`` on a legacy target aux (and on a rank-capped one,
  where both packages silently take the next softmax form);
- ``WEIGHTED_KERNEL`` switched on in both packages and restored;
- ``softmax_tilemax="auto"`` on a batch inside the spread bound and on one
  outside it (``test_tilemax_auto_guard_matches_jax``);
- the singleton-split (``src_rank_cap``) and two-region (``src_split_cap``)
  src layouts.

Tolerances as in ``tests/test_torch_edge_bwd.py``: f32 3e-4 of each
tensor's scale (the packages differ in summation order), bench flags (bf16
edge stage) 4e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyhgt_tpu.ops.sorted_hgt as jax_sorted_hgt
from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JaxMeta
from pyhgt_tpu.sampling.sorted_batch import sort_batch as jax_sort
from pyhgt_tpu_torch.ops import sorted_hgt
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch
from test_torch_edge_bwd import DIN, H, NAMES, SETTINGS, _inputs, _layouts
from test_torch_sorted_batch_src import aligned_layouts

F32 = dict(seg_pallas=True, softmax_tilemax=False)
BENCH = SETTINGS["bench-flags"]["flags"]
BENCH_SORT = SETTINGS["bench-flags"]["sort"]
# route -> (layout, flags, sort kwargs, tolerance)
ROUTES = {
    "recompute-window": ("two-type", dict(F32, edge_bwd="recompute"), {}, 3e-4),
    "recompute-bench-flags": ("tiny", dict(BENCH, edge_bwd="recompute"),
                              BENCH_SORT, 4e-2),
    "src_direct-window": ("two-type", dict(F32, edge_bwd="src_direct"), {},
                          3e-4),
    "src_direct-no-window": ("tiny", dict(F32, edge_bwd="src_direct"), {},
                             3e-4),
    "slab-window": ("two-type", dict(F32, edge_bwd="slab"), {}, 3e-4),
    "slab-no-window": ("tiny", dict(F32, edge_bwd="slab"), {}, 3e-4),
    "slab-bench-flags": ("two-type", dict(BENCH, edge_bwd="slab"), BENCH_SORT,
                         4e-2),
    "softmax_pallas": ("two-type", dict(F32, softmax_pallas=True), {}, 3e-4),
    "softmax_pallas-capped-aux": (
        "two-type", dict(F32, softmax_pallas=True, softmax_tilemax="on"),
        dict(tgt_rank_cap=136), 3e-4),
    "src_rank_cap": ("aligned", dict(F32, save_kv=True),
                     dict(src_rank_cap=128), 3e-4),
    "src_split_cap": ("aligned", dict(F32, save_kv=True),
                      dict(src_split_cap=128), 3e-4),
    "src_split_cap-window": ("two-type", dict(F32, edge_bwd="src_direct"),
                             dict(src_split_cap=256), 3e-4),
}


def _case(layout):
    jl, tl = aligned_layouts() if layout == "aligned" else _layouts(layout)
    return (jl, tl) + _inputs(tl)


def _jax_flags(flags):
    flags = dict(flags)
    bwd = flags.pop("edge_bwd", "permute")
    bf16 = flags.pop("edge_bf16", False)
    return dict(flags, bwd_recompute=bwd == "recompute",
                bwd_src_direct=bwd == "src_direct", bwd_slab=bwd == "slab",
                edge_dtype=jnp.bfloat16 if bf16 else None)


def _compare(case, flags, sort_kw, tol, scale_q=1.0):
    """Both packages' layer on the same inputs; returns the port's sorted
    batch. ``scale_q`` multiplies the query weights (larger logits)."""
    jl, tl, batch, P, rte_vec, tgt = case
    P = dict(P, wq=P["wq"] * np.float32(scale_q))
    x = batch.node_feat
    jse = jax_sort(batch, jl, native=False, **sort_kw)
    jem = JaxMeta.from_layout(jl)
    jflags = _jax_flags(flags)

    def jloss(x, rte, P):
        out = jax_sorted_hgt.hgt_conv_core_sorted(
            x, jse, jem, **P, n_heads=H, rte_vec=rte, **jflags)
        return jnp.sum(out * tgt), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(rte_vec),
        {k: jnp.asarray(v) for k, v in P.items()})

    se = sort_batch(batch, tl, **sort_kw)
    tflags = dict(flags)
    bf16 = tflags.pop("edge_bf16", False)
    tx = torch.tensor(x, requires_grad=True)
    trte = torch.tensor(rte_vec, requires_grad=True)
    tP = {k: torch.tensor(v, requires_grad=True) for k, v in P.items()}
    out = sorted_hgt.hgt_conv_core_sorted(
        tx, se.to("cpu"), EdgeStaticMeta.from_layout(tl).to("cpu"), **tP,
        n_heads=H, rte_vec=trte,
        edge_dtype=torch.bfloat16 if bf16 else None, **tflags)
    (out * torch.tensor(tgt)).sum().backward()

    def close(got, want, what):
        want = np.asarray(want)
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        assert np.isfinite(got).all(), what
        assert err <= tol * scale, (what, err, scale)

    close(out.detach().numpy(), jout, "out")
    close(tx.grad.numpy(), jgrads[0], "x")
    close(trte.grad.numpy(), jgrads[1], "rte_vec")
    for k in NAMES:
        close(tP[k].grad.numpy(), jgrads[2][k], k)
    return se


def _spy(monkeypatch, name):
    """Count the calls of ``sorted_hgt.<name>``."""
    calls = []
    real = getattr(sorted_hgt, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return real(*a, **kw)
    monkeypatch.setattr(sorted_hgt, name, wrapped)
    return calls


# which of the port's kernel wrappers each route must (not) go through
EXPECT_CALLS = {
    "slab-window": dict(live_partials_slab=2, live_partials_pair=0),
    "slab-no-window": dict(live_partials_slab=2, live_partials_pair=0),
    "slab-bench-flags": dict(live_partials_slab=2, live_partials_pair=0),
    "recompute-window": dict(live_partials_slab=0, live_partials_pair=2),
    "src_direct-window": dict(live_partials_slab=0, live_partials_pair=2),
    "softmax_pallas": dict(segment_softmax_partials=1),
    "softmax_pallas-capped-aux": dict(segment_softmax_partials=0),
    "src_rank_cap": dict(live_partials_pair=2),
    "src_split_cap": dict(live_partials_pair=2),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_outputs_and_gradients_match_jax(route, monkeypatch):
    layout, flags, sort_kw, tol = ROUTES[route]
    spies = {name: _spy(monkeypatch, name)
             for name in EXPECT_CALLS.get(route, {})}
    se = _compare(_case(layout), flags, sort_kw, tol)
    for name, n in EXPECT_CALLS.get(route, {}).items():
        assert len(spies[name]) == n, (name, len(spies[name]))
    assert (se.ptab_src is not None) == (layout == "two-type")
    if route.startswith("src_rank_cap"):
        assert se.pseg_src_multi is not None
    if route.startswith("src_split_cap"):
        assert se.pseg_src_lo is not None


@pytest.mark.parametrize("setting", ["f32", "bench-flags"])
def test_weighted_kernel_route_matches_jax(setting, monkeypatch):
    """``WEIGHTED_KERNEL`` on in both packages (and restored): the forward
    aggregation and g_q_n go through ``live_partials_weighted``. With bf16
    values the JAX kernel rounds each product to bf16 and the port does not:
    inside the bench flags' 4e-2."""
    cfg = SETTINGS[setting]
    monkeypatch.setattr(jax_sorted_hgt, "WEIGHTED_KERNEL", True)
    monkeypatch.setattr(sorted_hgt, "WEIGHTED_KERNEL", True)
    weighted = _spy(monkeypatch, "live_partials_weighted")
    single = _spy(monkeypatch, "live_partials")
    # the JAX package's weighted kernel takes the legacy aux only (its
    # retire assumes V = K): no target rank cap here
    sort_kw = {k: v for k, v in cfg["sort"].items() if k != "tgt_rank_cap"}
    _compare(_case("two-type"), cfg["flags"], sort_kw, cfg["tol"])
    assert len(weighted) == 2 and len(single) == 0
    monkeypatch.undo()
    assert not sorted_hgt.WEIGHTED_KERNEL
    assert not jax_sorted_hgt.WEIGHTED_KERNEL


@pytest.mark.parametrize("scale_q,falls_back", [(1.0, False), (60.0, True)],
                         ids=["inside-the-bound", "outside-the-bound"])
def test_tilemax_auto_guard_matches_jax(scale_q, falls_back, monkeypatch):
    """Query weights scaled until a tile's live logits spread past
    ``TILEMAX_SPREAD``: the port then takes the shift-scan softmax, as the
    JAX package's ``lax.cond`` does, and both still agree."""
    tiled = _spy(monkeypatch, "_softmax_tiled")
    tilemax = _spy(monkeypatch, "_softmax_tilemax")
    _compare(_case("two-type"), dict(F32, softmax_tilemax="auto"), {}, 3e-4,
             scale_q=scale_q)
    assert (len(tiled), len(tilemax)) == ((1, 0) if falls_back else (0, 1))
    assert sorted_hgt.TILEMAX_SPREAD == jax_sorted_hgt.TILEMAX_SPREAD == 80.0


def test_return_attention_matches_jax():
    jl, tl, batch, P, rte_vec, _ = _case("two-type")
    jse = jax_sort(batch, jl, native=False)
    jem = JaxMeta.from_layout(jl)
    jout, jw = jax.jit(lambda x, rte, P: jax_sorted_hgt.hgt_conv_core_sorted(
        x, jse, jem, **P, n_heads=H, rte_vec=rte, seg_pallas=True,
        return_attention=True))(
        jnp.asarray(batch.node_feat), jnp.asarray(rte_vec),
        {k: jnp.asarray(v) for k, v in P.items()})
    se = sort_batch(batch, tl).to("cpu")
    tP = {k: torch.tensor(v, requires_grad=True) for k, v in P.items()}
    out, w = sorted_hgt.hgt_conv_core_sorted(
        torch.tensor(batch.node_feat), se,
        EdgeStaticMeta.from_layout(tl).to("cpu"), **tP, n_heads=H,
        rte_vec=torch.tensor(rte_vec), seg_pallas=True, return_attention=True)
    assert w.shape == (se.edge_tgt.shape[0], H) and not w.requires_grad
    assert out.requires_grad
    # softmax weights in [0, 1]: the JAX package's denominators are
    # differences of f32 cumsums over the live rows (seen 9.2e-5 of a
    # weight), the port adds each segment's rows directly: 2e-4
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4 * np.abs(np.asarray(jout)).max())
    # every target's live weights sum to 1 per head; masked edges weigh 0
    mask = se.edge_mask.numpy()
    assert (w.numpy()[~mask] == 0).all()
    sums = np.zeros((tl.num_types * tl.node_cap, H))
    np.add.at(sums, se.edge_tgt.numpy()[mask], w.numpy()[mask])
    np.testing.assert_allclose(sums[sums.sum(1) > 0], 1.0, atol=1e-5)


def test_unknown_strategy_is_refused():
    _, tl, batch, P, rte_vec, _ = _case("tiny")
    with pytest.raises(ValueError, match="edge_bwd"):
        sorted_hgt.hgt_conv_core_sorted(
            torch.tensor(batch.node_feat), sort_batch(batch, tl).to("cpu"),
            EdgeStaticMeta.from_layout(tl).to("cpu"),
            **{k: torch.tensor(v) for k, v in P.items()}, n_heads=H,
            rte_vec=torch.tensor(rte_vec), edge_bwd="scatter")
    assert DIN == 16
