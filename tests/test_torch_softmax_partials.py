"""The port's ``segment_softmax_partials`` and the level-2 merge built on it
(``ops/sorted_hgt._softmax_pallas``) against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests do
(same parametrisation as ``tests/test_pallas_seg.py``, plus layouts that
meet the CUDA kernel's lane chunks at their edges). The CUDA kernel is held
against the plain version in ``test_cuda_kernel_matches_plain`` and
``test_cuda_kernel_on_sparse_loc``, on outputs whose memory held NaN and
twice for bit-identical sums; they need the card. The JAX package is
imported inside a fixture, so on the card's machine (which has no JAX)
those tests run alone:

    python -m pytest tests/test_torch_softmax_partials.py -m cuda --noconftest -o addopts="" -q
"""

import types

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.ops import sorted_hgt
from pyhgt_tpu_torch.ops.pallas_seg import (
    PK, PallasSegAux, segment_softmax_partials,
    segment_softmax_partials_plain,
)
from pyhgt_tpu_torch.sampling.sorted_batch import (
    pallas_seg_aux, pallas_tab_window_aux,
)

H = 8


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    from pyhgt_tpu.ops import pallas_seg as jseg
    from pyhgt_tpu.ops import sorted_hgt as jsh
    from pyhgt_tpu.sampling import sorted_batch as jsb

    return jseg, jsh, jsb


def _case(E, S, n_pad, layout):
    """Sorted keys with a masked tail (sentinel S) and logits whose masked
    rows carry -1e30, as the edge stage's do. ``layout`` shapes the runs
    against the CUDA kernel's lane chunks (C = PK / 32 = 12 rows a lane)."""
    rng = np.random.default_rng(E + S + n_pad)
    n = E - n_pad
    if layout == "hub":
        # one segment owns half the edges (spans more than two tiles)
        keys = np.concatenate([np.zeros(n // 2, np.int64),
                               np.sort(rng.integers(1, S, size=n - n // 2))])
    elif layout == "distinct":
        keys = np.arange(n)                          # every row a run
    elif layout == "one-run":
        # tile 0 one run over every lane chunk, tile 1 random
        keys = np.concatenate([np.zeros(PK, np.int64),
                               np.sort(rng.integers(1, S, size=n - PK))])
    elif layout == "chunk-aligned":
        # runs of 12, 24 or 36 rows from row 0: each starts and ends on a
        # lane-chunk boundary
        lengths = 12 * rng.integers(1, 4, size=n // 12)
        keys = np.repeat(np.arange(n // 12), lengths)[:n]
    else:        # "random", "masked-tile", "long-tail": any sorted keys
        keys = np.sort(rng.integers(0, min(S, 40) if layout == "long-tail"
                                    else S, size=n))
    keys = np.concatenate([keys, np.full(n_pad, S)]).astype(np.int64)
    att = (rng.normal(size=(E, H)) * 4).astype(np.float32)
    att[keys == S] = -1e30
    if layout == "masked-tile":
        att[PK:2 * PK] = -1e30          # tile 1: live keys, masked logits
    return keys, att


def _live_rows(aux):
    """Rows [0, n) that some (tile, run) reaches; the rest is the tail."""
    loc, blk = np.asarray(aux.loc), np.asarray(aux.blk)
    return int(blk[loc.shape[0] - 1]) * aux.w + int(loc[-1, -1]) + 1


CASES = [
    pytest.param(PK, 40, 7, "random", id="single-tile"),
    pytest.param(4 * PK, 300, 500, "random", id="padding-tail"),
    pytest.param(8 * PK, 17, 3, "hub", id="hub"),
    pytest.param(2 * PK, 2 * PK, 0, "distinct", id="every-row-a-run"),
    pytest.param(2 * PK, 40, 0, "one-run", id="run-over-every-chunk"),
    pytest.param(2 * PK, 2 * PK, 0, "chunk-aligned", id="chunk-aligned-runs"),
    pytest.param(2 * PK, 60, 0, "masked-tile", id="all-masked-tile"),
    # 40 of 1,920 output rows live: a long tail of rows no run reaches
    pytest.param(PK, 1500, 0, "long-tail", id="long-tail"),
]


@pytest.mark.parametrize("E,S,n_pad,layout", CASES)
def test_plain_matches_jax_kernel(jax_side, E, S, n_pad, layout):
    import jax.numpy as jnp

    jseg, _, jsb = jax_side
    keys, att = _case(E, S, n_pad, layout)
    aux, jaux = pallas_seg_aux(keys, S), jsb.pallas_seg_aux(keys, S)
    before = segment_softmax_partials.launches
    m, s = segment_softmax_partials(torch.from_numpy(att), aux.to("cpu"))
    assert segment_softmax_partials.launches == before  # CPU: no launch
    jm, js = jseg.segment_softmax_partials(jnp.asarray(att), jaux)
    jm, js = np.asarray(jm), np.asarray(js)
    assert m.shape == jm.shape == s.shape == (aux.num_blocks * aux.w, H)
    # the emitted max is the bf16 rounding of the slice's max: bit-equal
    np.testing.assert_array_equal(m.numpy(), jm)
    # the sums: the JAX kernel adds a bf16 hi/lo split of each exp (~2^-17
    # of the value), the port adds f32 values: 1e-5 of the value
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-5, atol=1e-30)
    live = _live_rows(aux)
    assert live < m.shape[0]
    assert not m[live:].any() and not s[live:].any()
    if layout == "masked-tile":
        rows = np.unique(aux.blk[1] * aux.w + aux.loc[1])
        assert np.isfinite(jm[rows]).all() and (jm[rows] < -9e29).all()
        assert not js[rows].any()


def test_output_contract():
    """Dead rows are 0 in both outputs; m is the bf16 rounding (to nearest
    even) of the run's max; a masked row inside a live run adds nothing; a
    run of masked rows only has a finite m and s = 0."""
    loc = np.array([[0, 0, 0, 2, 2, 3, 3, 3]], np.int32)
    aux = PallasSegAux(loc=loc, blk=np.array([0, 1], np.int32),
                       ptr2=np.zeros(1, np.int32), w=8, v=0).to("cpu")
    att = torch.zeros(8, 2)
    att[:, 0] = torch.tensor([1.0, 3.1416, 2.0, -1e30, 0.5, -1e30, -1e30, -1e30])
    att[:, 1] = torch.tensor([-7.3, -9.0, -8.0, 100.7, 100.2, -1e30, -1e30, -1e30])
    m, s = segment_softmax_partials(att, aux)
    assert m.shape == s.shape == (16, 2)
    live = [0, 2, 3]
    dead = [r for r in range(16) if r not in live]
    assert (m[dead] == 0).all() and (s[dead] == 0).all()
    # 3.1416 rounds to 3.140625 in bf16 (8 significant bits), not down to
    # 3.125 as truncation would give
    assert m[0, 0].item() == 3.140625
    assert m[0, 1].item() == torch.tensor(-7.3).bfloat16().float().item()
    want = sum(np.exp(np.float32(a) - np.float32(3.140625))
               for a in (1.0, 3.1416, 2.0))
    assert s[0, 0].item() == pytest.approx(want, rel=1e-6)
    # run 2: a masked row and a live one share the run
    assert m[2, 0].item() == 0.5 and s[2, 0].item() == pytest.approx(1.0)
    # run 3: masked rows only
    assert torch.isfinite(m[3]).all() and m[3, 0].item() < -9e29
    assert (s[3] == 0).all()


@pytest.mark.parametrize("E,S,n_pad,layout", CASES[1:3])
def test_level2_merge_matches_jax(jax_side, E, S, n_pad, layout):
    """``_softmax_pallas``: the kernel's partials merged per segment, both
    packages on the same sorted keys and logits, and against an f64
    per-segment softmax."""
    import jax
    import jax.numpy as jnp

    _, jsh, jsb = jax_side
    keys, att = _case(E, S, n_pad, layout)
    mask = keys < S
    safe = np.where(mask, keys, S - 1).astype(np.int32)
    se = types.SimpleNamespace(
        pseg_tgt=pallas_seg_aux(keys, S).to("cpu"),
        edge_tgt=torch.from_numpy(safe), edge_mask=torch.from_numpy(mask))
    jse = types.SimpleNamespace(
        pseg_tgt=jsb.pallas_seg_aux(keys, S), edge_tgt=jnp.asarray(safe),
        edge_mask=jnp.asarray(mask))
    w = sorted_hgt._softmax_pallas(torch.from_numpy(att), se).numpy()
    jw = np.asarray(jax.jit(lambda a: jsh._softmax_pallas(a, jse))(
        jnp.asarray(att)))
    # same algebra on the same rounded maxima, but the JAX package's level 2
    # is a difference of f32 cumsums over the live rows (cancellation at
    # ~6e-8 of the running sum; seen 5.7e-5 of a weight), the port adds each
    # segment's rows directly: 2e-4 (the JAX package's own test holds its
    # weights to 2e-3)
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-5)
    ref = np.zeros_like(att, dtype=np.float64)
    for seg in np.unique(keys[mask]):
        idx = np.flatnonzero(keys == seg)
        z = np.exp(att[idx].astype(np.float64) - att[idx].max(axis=0))
        ref[idx] = z / z.sum(axis=0)
    np.testing.assert_allclose(w, ref, rtol=1e-4, atol=1e-6)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    keys, att = _case(2 * PK, 40, 5, "random")
    aux = pallas_seg_aux(keys, 40).to("cpu")
    t = torch.from_numpy(att)
    with pytest.raises(ValueError, match="aux tiles"):
        segment_softmax_partials(t[:PK], aux)
    with pytest.raises(ValueError, match=r"\[E, H\]"):
        segment_softmax_partials(t[:, 0], aux)
    # the walk needs sorted runs: no window aux
    tab = np.concatenate([b * 64 + np.arange(PK) % 64 for b in range(2)])
    window = pallas_tab_window_aux(tab.astype(np.int64), 2, 64, PK, 64)
    with pytest.raises(ValueError, match="runs aux"):
        segment_softmax_partials(t, window.to("cpu"))


def _poisoned_call(att, gaux):
    """The wrapper on memory that held NaN: two NaN tensors of the outputs'
    size are made and freed first, so the caching allocator hands that
    memory to the wrapper's ``torch.empty`` and any row the kernel does not
    write shows as NaN."""
    shape = (gaux.num_blocks * gaux.w, att.shape[1])
    bait = [torch.full(shape, float("nan"), device=att.device)
            for _ in range(2)]
    ptrs = [b.data_ptr() for b in bait]
    del bait
    m, s = segment_softmax_partials(att, gaux)
    assert [m.data_ptr(), s.data_ptr()] == ptrs, "outputs not on NaN memory"
    return m, s


def _check_cuda(att, gaux):
    before = segment_softmax_partials.launches
    m, s = _poisoned_call(att, gaux)
    torch.cuda.synchronize()
    assert segment_softmax_partials.launches == before + 1
    pm, ps = segment_softmax_partials_plain(att, gaux)
    # the rounded max must be bit-equal; the sums add the same f32 exps in
    # another order, with expf against torch.exp (a few ulps each)
    assert torch.equal(m, pm)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-30)
    # the kernel's sums combine lanes in a fixed order: a second call gives
    # the same bits
    m2, s2 = _poisoned_call(att, gaux)
    assert torch.equal(m2, m) and torch.equal(s2, s)


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,n_pad,layout", CASES)
def test_cuda_kernel_matches_plain(E, S, n_pad, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    keys, att = _case(E, S, n_pad, layout)
    _check_cuda(torch.from_numpy(att).cuda(), pallas_seg_aux(keys, S).to("cuda"))


def _gap_aux(rng, K=32, n_tiles=3, W=256):
    """A runs aux whose loc skips values: each tile's runs lie up to 60
    rows apart (more slots than rows, K = 32), with gaps between tiles."""
    loc = np.zeros((n_tiles, K), np.int32)
    blk = np.zeros(n_tiles, np.int32)
    row = 0
    for t in range(n_tiles):
        rel = np.sort(rng.integers(0, 60, K))
        rel -= rel[0]
        blk[t] = row // W
        loc[t] = row - blk[t] * W + rel
        row += int(rel[-1]) + 1 + int(rng.integers(0, 5))
    nb = row // W + 2
    blk = np.concatenate([blk, np.full(nb - 1, nb - 1, np.int32)])
    return PallasSegAux(loc=loc, blk=blk, ptr2=np.zeros(1, np.int32), w=W)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["output-contract", "loc-gaps"])
def test_cuda_kernel_on_sparse_loc(layout):
    """Layouts no host sort makes but the runs contract allows: the output
    contract's aux (K = 8, H = 2, a skipped row) and tiles whose runs span
    more slots than rows, so the kernel stores some rows directly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(7)
    if layout == "output-contract":
        aux = PallasSegAux(loc=np.array([[0, 0, 0, 2, 2, 3, 3, 3]], np.int32),
                           blk=np.array([0, 1], np.int32),
                           ptr2=np.zeros(1, np.int32), w=8)
        att = rng.normal(size=(8, 2)).astype(np.float32)
        att[5:, :] = -1e30
    else:
        aux = _gap_aux(rng)
        att = (rng.normal(size=(aux.loc.size, H)) * 4).astype(np.float32)
    _check_cuda(torch.from_numpy(att).cuda(), aux.to("cuda"))
