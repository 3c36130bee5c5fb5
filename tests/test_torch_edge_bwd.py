"""The edge stage's hand-written backward against the JAX package's.

One ``hgt_conv_core_sorted`` layer of each package takes the same weights
and inputs (numpy, seeded); the loss is ``sum(out * tgt)``. Outputs and the
gradients of the node features, every weight bank and the RTE vectors are
held against ``jax.value_and_grad``, whose backward is the JAX package's
``_edge_bwd`` with its Pallas kernels in interpret mode. Two layouts:

- ``two-type`` (node cap 512, edge cap 1024): every edge block exceeds the
  kernel tile, so the tab-window aux builds and the RTE-table gradients go
  through ``live_partials_pair`` on a window aux;
- ``tiny`` (the flagship's tiny preset): a tile spans several blocks, there
  is no window aux, and the RTE-table gradients take the fallback through
  ``perm_tab`` and ``pseg_tab``.

Inside the port, the ``torch.autograd.Function``'s backward is also held
against plain autograd through the same forward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyhgt_tpu.flagship import build_flagship as jax_build
from pyhgt_tpu.ops.hgt import EdgeStaticMeta as JaxMeta
from pyhgt_tpu.ops.sorted_hgt import hgt_conv_core_sorted as jax_core
from pyhgt_tpu.sampling.sorted_batch import sort_batch as jax_sort
from pyhgt_tpu_torch.flagship import build_flagship
from pyhgt_tpu_torch.ops import sorted_hgt
from pyhgt_tpu_torch.ops.hgt import EdgeStaticMeta
from pyhgt_tpu_torch.ops.pallas_seg import live_partials, live_partials_pair
from pyhgt_tpu_torch.ops.rte import RTE_MAX_LEN
from pyhgt_tpu_torch.ops.sorted_hgt import hgt_conv_core_sorted
from pyhgt_tpu_torch.sampling.sorted_batch import sort_batch
from pyhgt_tpu_torch.utils.synth import synth_batch
from test_torch_sorted_batch import two_type_layouts

H, DIN, DOUT = 4, 16, 128
NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "rel_pri", "rel_att", "rel_msg")

# f32: the packages differ in summation order. The JAX package's level 2 is
# a difference of f32 cumsums over up to ~40k live rows (cancellation at
# ~6e-8 of the running sum), its kernel sums a bf16 hi/lo split (~2^-16 per
# value); the port adds each segment's rows directly. Seen: up to 1.3e-4 of
# a tensor's scale (5.8e-5 on the outputs); the bound is 3e-4. bench flags: every per-edge tensor, the saved k_e/v_e
# and the per-edge gradient products round to bf16 (2^-8 relative) at
# different places in the two frameworks, and a gradient sums many such
# terms with mixed signs: 4e-2 of the tensor's scale bounds what was seen
# (1.6e-2 at most).
SETTINGS = {
    "f32": dict(flags=dict(seg_pallas=True, softmax_tilemax=False),
                sort=dict(), tol=3e-4),
    "bench-flags": dict(
        flags=dict(seg_pallas=True, softmax_tilemax="on", save_kv=True,
                   edge_bf16=True),
        sort=dict(tgt_rank_cap=136, tab_cap=64), tol=4e-2),
}


def _layouts(name):
    if name == "two-type":
        return two_type_layouts()
    return jax_build("tiny").layout, build_flagship("tiny", device="cpu").layout


def _inputs(tl):
    """A batch, a layer's weights, RTE vectors and the loss's target."""
    rng = np.random.default_rng(13)
    batch = synth_batch(tl, np.random.default_rng(9), din=DIN, node_fill=0.9,
                        edge_fill=0.9)
    # 40 of the 240 dt slots, so that a tab cap of 64 holds
    batch.edge_dt[:] = 100 + batch.edge_dt % 40
    T, C, R = tl.num_types, tl.node_cap, tl.schema.num_relations
    dk = DOUT // H
    f32 = np.float32
    P = {
        "wq": rng.normal(size=(T, DIN, DOUT)).astype(f32) * 0.3,
        "bq": rng.normal(size=(T, DOUT)).astype(f32) * 0.1,
        "wk": rng.normal(size=(T, DIN, DOUT)).astype(f32) * 0.3,
        "bk": rng.normal(size=(T, DOUT)).astype(f32) * 0.1,
        "wv": rng.normal(size=(T, DIN, DOUT)).astype(f32) * 0.3,
        "bv": rng.normal(size=(T, DOUT)).astype(f32) * 0.1,
        "rel_pri": (rng.normal(size=(R, H)) + 1).astype(f32),
        "rel_att": rng.normal(size=(R, H, dk, dk)).astype(f32) * 0.3,
        "rel_msg": rng.normal(size=(R, H, dk, dk)).astype(f32) * 0.3,
    }
    rte_vec = rng.normal(size=(RTE_MAX_LEN, DIN)).astype(f32) * 0.5
    tgt = rng.normal(size=(T, C, DOUT)).astype(f32)
    return batch, P, rte_vec, tgt


@pytest.fixture(scope="module", params=["two-type", "tiny"])
def case(request):
    jl, tl = _layouts(request.param)
    return (request.param, jl, tl) + _inputs(tl)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_layer_outputs_and_gradients_match_jax(case, setting):
    layout, jl, tl, batch, P, rte_vec, tgt = case
    cfg = SETTINGS[setting]
    flags = dict(cfg["flags"])
    bf16 = flags.pop("edge_bf16", False)
    x = batch.node_feat

    jse = jax_sort(batch, jl, native=False, **cfg["sort"])
    jem = JaxMeta.from_layout(jl)

    def jloss(x, rte, P):
        out = jax_core(x, jse, jem, **P, n_heads=H, rte_vec=rte,
                       edge_dtype=jnp.bfloat16 if bf16 else None, **flags)
        return jnp.sum(out * tgt), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(rte_vec),
        {k: jnp.asarray(v) for k, v in P.items()})

    se = sort_batch(batch, tl, **cfg["sort"])
    assert (se.ptab_src is not None) == (layout == "two-type")
    assert (se.tab_sel is not None) == bool(cfg["sort"])
    tx = torch.tensor(x, requires_grad=True)
    trte = torch.tensor(rte_vec, requires_grad=True)
    tP = {k: torch.tensor(v, requires_grad=True) for k, v in P.items()}
    counts = live_partials.launches, live_partials_pair.launches
    out = hgt_conv_core_sorted(
        tx, se.to("cpu"), EdgeStaticMeta.from_layout(tl).to("cpu"), **tP,
        n_heads=H, rte_vec=trte,
        edge_dtype=torch.bfloat16 if bf16 else None, **flags)
    (out * torch.tensor(tgt)).sum().backward()
    # CPU tensors never launch a kernel
    assert counts == (live_partials.launches, live_partials_pair.launches)

    tol = cfg["tol"]

    def close(got, want, what):
        want = np.asarray(want)
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= tol * scale, (what, err, scale)

    close(out.detach().numpy(), jout, "out")
    close(tx.grad.numpy(), jgrads[0], "x")
    close(trte.grad.numpy(), jgrads[1], "rte_vec")
    for k in NAMES:
        close(tP[k].grad.numpy(), jgrads[2][k], k)


@pytest.mark.parametrize("tilemax", [False, True], ids=["tiled", "tilemax"])
@pytest.mark.parametrize("save_kv", [False, True], ids=["regather", "save-kv"])
def test_function_backward_matches_autograd_of_its_forward(case, tilemax,
                                                           save_kv):
    """f32, the port alone: the Function's backward against autograd
    through ``_edge_fwd_impl`` (on CPU tensors every piece of it is plain
    differentiable torch)."""
    layout, _, tl, batch, *_ = case
    se = sort_batch(batch, tl, tab_cap=64).to("cpu")
    T, C, B = tl.num_types, tl.node_cap, len(tl.blocks)
    dk = DOUT // H
    rng = np.random.default_rng(21)

    def leaf(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * scale,
                            requires_grad=True)
    ins = [leaf(T * C, DOUT), leaf(B * C, DOUT), leaf(B * C, DOUT),
           leaf(B * 64, DOUT, scale=0.3), leaf(B * 64, DOUT, scale=0.3),
           leaf(se.edge_tgt.shape[0], H)]
    g_out = torch.tensor(rng.normal(size=(T * C, DOUT)).astype(np.float32))

    def grads(fn):
        out = fn(*ins)
        return out, torch.autograd.grad((out * g_out).sum(), ins)

    out_f, g_f = grads(lambda *a: sorted_hgt.hgt_edge_stage(
        *a, se, H=H, dk=dk, use_rte=True, save_kv=save_kv, seg_pallas=True,
        softmax_tilemax=tilemax))
    out_a, g_a = grads(lambda *a: sorted_hgt._edge_fwd_impl(
        *a, se, H, dk, True, True, tilemax)[0])
    torch.testing.assert_close(out_f, out_a, rtol=0, atol=0)
    # the two backwards sum the same f32 terms in different groupings
    for name, a, b in zip(("q_n", "k_rel", "v_rel", "k_tab", "v_tab",
                           "pri_e"), g_f, g_a):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-5 * scale, (layout, name)


def test_no_grad_forward_saves_nothing_and_backward_needs_its_aux(case):
    _, _, tl, batch, P, rte_vec, _ = case
    em = EdgeStaticMeta.from_layout(tl).to("cpu")
    tP = {k: torch.tensor(v, requires_grad=True) for k, v in P.items()}
    kw = dict(n_heads=H, rte_vec=torch.tensor(rte_vec), seg_pallas=True)
    x = torch.tensor(batch.node_feat)
    with torch.no_grad():
        out = hgt_conv_core_sorted(
            x, sort_batch(batch, tl, with_backward=False).to("cpu"), em,
            **tP, **kw)
    assert out.grad_fn is None and not out.requires_grad
    # a forward-only sort cannot be differentiated, and says so
    out = hgt_conv_core_sorted(
        x, sort_batch(batch, tl, with_backward=False).to("cpu"), em, **tP,
        **kw)
    with pytest.raises(ValueError, match="with_backward"):
        out.sum().backward()
