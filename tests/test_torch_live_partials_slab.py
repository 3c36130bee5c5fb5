"""The port's ``live_partials_slab`` against the JAX package's Pallas kernel
on both kinds of aux the ``slab`` backward hands it (the src runs aux and
the tab-window aux), and the dead-row contract of the singleton-split aux
(``loc = -1`` rows that the kernels skip) for ``live_partials`` and
``live_partials_pair``.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX side
runs the Pallas kernels in interpret mode. The CUDA kernels are held against
the plain versions in the ``cuda``-marked tests, which need the card:

    python -m pytest tests/test_torch_live_partials_slab.py -m cuda --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.ops.pallas_seg import (
    PK, PallasSegAux, _check, check_rows, live_partials, live_partials_pair,
    live_partials_pair_plain, live_partials_plain, live_partials_slab,
    live_partials_slab_plain,
)
from pyhgt_tpu_torch.ops.sorted_hgt import seg_sum_csr
from pyhgt_tpu_torch.sampling.sorted_batch import (
    pallas_seg_aux, pallas_seg_aux_split, pallas_tab_window_aux,
)

SIZES = [3 * PK + 100, 2 * PK - 100, 3 * PK]   # edges per meta block
D = 128                                        # one half of the slab


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    from pyhgt_tpu.ops import pallas_seg as jseg
    from pyhgt_tpu.sampling import sorted_batch as jsb

    return jseg, jsb


def _aux_pair(kind, jsb=None):
    """(E, port aux, JAX aux or None): a src-like runs aux over sorted keys
    with a masked tail, or a tab-window aux over block-contiguous, unsorted
    table indices (L = W = 64, as the bench preset's tab_cap gives it)."""
    rng = np.random.default_rng(7)
    if kind == "runs":
        E, S = 4 * PK, 300
        keys = np.sort(rng.integers(0, S, size=E - 40))
        keys = np.concatenate([keys, np.full(40, S)]).astype(np.int64)
        args = (keys, S, PK, PK)
        return E, pallas_seg_aux(*args), jsb and jsb.pallas_seg_aux(*args)
    tab = np.concatenate([b * 64 + rng.integers(0, 64, size=s)
                          for b, s in enumerate(SIZES)]).astype(np.int64)
    args = (tab, len(SIZES), 64, PK, 64)
    return (tab.shape[0], pallas_tab_window_aux(*args),
            jsb and jsb.pallas_tab_window_aux(*args))


def _slab(E, dtype):
    data = np.random.default_rng(3).normal(size=(E, 2 * D)).astype(np.float32)
    return data, torch.from_numpy(data).to(getattr(torch, dtype))


@pytest.mark.parametrize("kind", ["runs", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(jax_side, kind, dtype):
    import jax.numpy as jnp

    jseg, jsb = jax_side
    E, aux, jaux = _aux_pair(kind, jsb)
    assert aux.window == (kind == "window")
    data, t = _slab(E, dtype)
    before = live_partials_slab.launches
    p1, p2 = live_partials_slab(t, aux.to("cpu"))
    assert live_partials_slab.launches == before  # CPU tensors never launch
    r1, r2 = jseg.live_partials_slab(jnp.asarray(data, getattr(jnp, dtype)),
                                     jaux)
    # f32: the JAX kernel sums a bf16 hi/lo split of f32 data (~2^-16 of each
    # value), the port sums f32 directly. bf16: both sum the same bf16 values
    # in f32; only the order differs. Window rows sum ~25 unit normals, so
    # their absolute term is ten times the runs'.
    tol = 1e-4 if dtype == "float32" else 1e-5
    atol = tol * (10 if kind == "window" else 1)
    for p, r in ((p1, r1), (p2, r2)):
        assert p.dtype == torch.float32 and p.shape == r.shape
        assert p.shape == (aux.num_blocks * aux.w, D)
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=tol,
                                   atol=atol)
    # the slab is the pair on the two lane halves
    q1, q2 = live_partials_pair(t[:, :D].contiguous(), t[:, D:].contiguous(),
                                aux.to("cpu"))
    torch.testing.assert_close(p1, q1, rtol=0, atol=0)
    torch.testing.assert_close(p2, q2, rtol=0, atol=0)


def test_wrapper_refuses_bad_shapes(jax_side):
    import jax.numpy as jnp

    jseg, jsb = jax_side
    E, aux, jaux = _aux_pair("runs", jsb)
    taux = aux.to("cpu")
    with pytest.raises(ValueError, match="128-aligned halves"):
        live_partials_slab(torch.zeros(E, 384), taux)
    with pytest.raises(ValueError, match="128-aligned halves"):
        jseg.live_partials_slab(jnp.zeros((E, 384)), jaux)
    with pytest.raises(ValueError, match="aux tiles"):
        live_partials_slab(torch.zeros(PK, 256), taux)


# ------------------------------------------------------------- dead rows
def _split_keys():
    """Sorted src-like keys where half the segments have one edge: the
    singletons become dead rows of the split aux."""
    rng = np.random.default_rng(5)
    deg = np.where(rng.random(500) < 0.5, 1, rng.integers(2, 9, size=500))
    keys = np.repeat(np.arange(500), deg)
    E = -(-keys.shape[0] // PK) * PK
    # the padded tail is one long run of the last segment
    return np.concatenate([keys, np.full(E - keys.shape[0], 499)]).astype(
        np.int64), 500


def test_split_aux_matches_jax_and_carries_dead_rows(jax_side):
    _, jsb = jax_side
    keys, S = _split_keys()
    kw = dict(v=136, single_cap=keys.shape[0] // 4)
    aux, edges, inv = pallas_seg_aux_split(keys, S, PK, 136, **kw)
    jaux, jedges, jinv = jsb.pallas_seg_aux_split(keys, S, PK, 136, **kw)
    for f in ("loc", "blk", "ptr2", "live_key"):
        np.testing.assert_array_equal(getattr(aux, f), getattr(jaux, f))
        assert getattr(aux, f).dtype == getattr(jaux, f).dtype
    np.testing.assert_array_equal(edges, jedges)
    np.testing.assert_array_equal(inv, jinv)
    assert aux.dead_rows and not aux.window and (aux.loc == -1).any()
    assert aux.loc.min() == -1
    check_rows(aux)
    # violated caps: no aux, in both packages
    for bad in (dict(v=8, single_cap=kw["single_cap"]),
                dict(v=136, single_cap=4)):
        assert pallas_seg_aux_split(keys, S, PK, 136, **bad) is None
        assert jsb.pallas_seg_aux_split(keys, S, PK, 136, **bad) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dead_rows_plain_pair_matches_jax_kernel_and_numpy(jax_side, dtype):
    import jax.numpy as jnp

    jseg, jsb = jax_side
    keys, S = _split_keys()
    E = keys.shape[0]
    kw = dict(v=136, single_cap=E // 4)
    aux, edges, inv = pallas_seg_aux_split(keys, S, PK, 136, **kw)
    jaux = jsb.pallas_seg_aux_split(keys, S, PK, 136, **kw)[0]
    rng = np.random.default_rng(3)
    d1 = rng.normal(size=(E, D)).astype(np.float32)
    d2 = rng.normal(size=(E, D)).astype(np.float32)
    t1 = torch.from_numpy(d1).to(getattr(torch, dtype))
    t2 = torch.from_numpy(d2).to(getattr(torch, dtype))
    taux = aux.to("cpu")
    p1, p2 = live_partials_pair(t1, t2, taux)
    jdt = getattr(jnp, dtype)
    r1, r2 = jseg.live_partials_pair(jnp.asarray(d1, jdt),
                                     jnp.asarray(d2, jdt), jaux)
    tol = 1e-4 if dtype == "float32" else 1e-5   # as for the slab above
    for p, r in ((p1, r1), (p2, r2)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=tol,
                                   atol=tol)
    # the single-tensor version skips the same rows
    torch.testing.assert_close(live_partials(t1, taux), p1, rtol=0, atol=0)
    # level 2 plus the singleton gather is the whole segment sum
    z = torch.zeros(1, D)
    g = torch.cat([t1.float()[torch.from_numpy(edges).long()], z])
    got = seg_sum_csr(p1, taux.ptr2) + g[torch.from_numpy(inv).long()]
    ref = np.zeros((S, D))
    np.add.at(ref, keys, t1.double().numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def _hand_aux(loc, dead_rows, window=False):
    """2 tiles of K = 4, W = V = 4, NB = 2 blocks."""
    return PallasSegAux(loc=np.array(loc, np.int32),
                        blk=np.array([0, 1, 1], np.int32),
                        ptr2=np.zeros(1, np.int32), w=4, v=4,
                        dead_rows=dead_rows, window=window)


def test_plain_skips_dead_rows_between_runs():
    # a -1 between two runs, before a tile's first run and at a tile's end
    aux = _hand_aux([[0, -1, 1, 1], [-1, 0, 0, -1]], dead_rows=True).to("cpu")
    data = torch.arange(1.0, 9.0)[:, None].repeat(1, 4)
    out = live_partials_plain(data, aux)
    np.testing.assert_array_equal(out[:, 0].numpy(),
                                  [1, 3 + 4, 0, 0, 6 + 7, 0, 0, 0])
    o1, o2 = live_partials_pair_plain(data, 2 * data, aux)
    torch.testing.assert_close(o1, out, rtol=0, atol=0)
    torch.testing.assert_close(o2, 2 * out, rtol=0, atol=0)


@pytest.mark.parametrize("loc,dead_rows,window", [
    ([[0, -1, 1, 1], [-1, 0, 0, -1]], False, False),  # not marked
    ([[0, -2, 1, 1], [0, 0, 1, 1]], True, False),     # below the dead mark
    ([[1, -1, 0, 1], [0, 0, 1, 1]], True, False),     # live entries unsorted
    ([[0, -1, 1, 4], [-1, 0, 0, 1]], True, False),    # tiles share row 4
    ([[0, -1, 1, 1], [0, 0, 1, 1]], True, True),      # a window has none
], ids=["unmarked", "below-dead-mark", "unsorted", "tiles-overlap", "window"])
def test_check_rows_holds_the_contract_over_live_entries(loc, dead_rows,
                                                         window):
    with pytest.raises(ValueError, match="contract"):
        _hand_aux(loc, dead_rows, window).to("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["runs", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_slab_kernel_matches_plain(kind, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    E, aux, _ = _aux_pair(kind)
    gaux = aux.to("cuda")
    t = torch.from_numpy(np.random.default_rng(3).normal(
        size=(E, 1024)).astype(np.float32)).to(getattr(torch, dtype)).cuda()
    counts = live_partials_slab.launches, live_partials_slab.window_launches
    got = live_partials_slab(t, gaux)
    torch.cuda.synchronize()
    assert (live_partials_slab.launches, live_partials_slab.window_launches
            ) == (counts[0] + 1, counts[1] + int(kind == "window"))
    # the same f32 sums in another order (atomics in the window case)
    for g, w in zip(got, live_partials_slab_plain(t, gaux)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_skip_dead_rows(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    keys, S = _split_keys()
    E = keys.shape[0]
    gaux = pallas_seg_aux_split(keys, S, PK, 136, v=136,
                                single_cap=E // 4)[0].to("cuda")
    gen = torch.Generator().manual_seed(0)
    t1 = torch.randn(E, 512, generator=gen).to(getattr(torch, dtype)).cuda()
    t2 = torch.randn(E, 512, generator=gen).to(getattr(torch, dtype)).cuda()
    _check(t1, gaux)
    got = (live_partials(t1, gaux), *live_partials_pair(t1, t2, gaux))
    torch.cuda.synchronize()
    want = (live_partials_plain(t1, gaux),
            *live_partials_pair_plain(t1, t2, gaux))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
