"""The port's ``segment_softmax_partials`` and the level-2 merge built on it
(``ops/sorted_hgt._softmax_pallas``) against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests do
(same parametrisation as ``tests/test_pallas_seg.py``). The CUDA kernel is
held against the plain version in ``test_cuda_kernel_matches_plain``, which
needs the card; the JAX package is imported inside a fixture, so on the
card's machine (which has no JAX) that test runs alone:

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


def _case(E, S, n_pad, hub):
    """Sorted keys with a masked tail (sentinel S) and logits whose masked
    rows carry -1e30, as the edge stage's do."""
    rng = np.random.default_rng(E + S + n_pad)
    n = E - n_pad
    if hub:
        # one segment owns half the edges (spans more than two tiles)
        keys = np.concatenate([np.zeros(n // 2, np.int64),
                               np.sort(rng.integers(1, S, size=n - n // 2))])
    else:
        keys = np.sort(rng.integers(0, S, size=n))
    keys = np.concatenate([keys, np.full(n_pad, S)]).astype(np.int64)
    att = (rng.normal(size=(E, H)) * 4).astype(np.float32)
    att[keys == S] = -1e30
    return keys, att


CASES = [
    pytest.param(PK, 40, 7, False, id="single-tile"),
    pytest.param(4 * PK, 300, 500, False, id="padding-tail"),
    pytest.param(8 * PK, 17, 3, True, id="hub"),
]


@pytest.mark.parametrize("E,S,n_pad,hub", CASES)
def test_plain_matches_jax_kernel(jax_side, E, S, n_pad, hub):
    import jax.numpy as jnp

    jseg, _, jsb = jax_side
    keys, att = _case(E, S, n_pad, hub)
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


@pytest.mark.parametrize("E,S,n_pad,hub", CASES[1:])
def test_level2_merge_matches_jax(jax_side, E, S, n_pad, hub):
    """``_softmax_pallas``: the kernel's partials merged per segment, both
    packages on the same sorted keys and logits, and against an f64
    per-segment softmax."""
    import jax
    import jax.numpy as jnp

    _, jsh, jsb = jax_side
    keys, att = _case(E, S, n_pad, hub)
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
    keys, att = _case(2 * PK, 40, 5, False)
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


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,n_pad,hub", CASES)
def test_cuda_kernel_matches_plain(E, S, n_pad, hub):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    keys, att = _case(E, S, n_pad, hub)
    gaux = pallas_seg_aux(keys, S).to("cuda")
    t = torch.from_numpy(att).cuda()
    before = segment_softmax_partials.launches
    m, s = segment_softmax_partials(t, gaux)
    torch.cuda.synchronize()
    assert segment_softmax_partials.launches == before + 1
    pm, ps = segment_softmax_partials_plain(t, gaux)
    # the rounded max must be bit-equal; the sums add the same f32 exps in
    # another order, with expf against torch.exp (a few ulps each)
    assert torch.equal(m, pm)
    torch.testing.assert_close(s, ps, rtol=1e-5, atol=1e-30)
