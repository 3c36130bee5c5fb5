"""The port's ``live_partials_pair`` (pyhgt_tpu_torch/ops/pallas_seg.py)
against the JAX package's Pallas kernel, for both kinds of aux it takes.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests do.
A *runs* aux (``pallas_seg_aux``) numbers sorted keys; a *window* aux
(``pallas_tab_window_aux``) addresses block-contiguous but unsorted table
indices through a two-block window. The CUDA kernel is held against the
plain version in ``test_cuda_kernel_matches_plain``, which needs the card;
the JAX package is imported inside a fixture, so on the card's machine
(which has no JAX) that test runs alone:

    python -m pytest tests/test_torch_live_partials_pair.py -m cuda --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.ops.pallas_seg import (
    PK, PallasSegAux, _check, check_rows, live_partials, live_partials_pair,
    live_partials_pair_plain, live_partials_slab, live_partials_slab_plain,
    out_rows,
)
from pyhgt_tpu_torch.ops.sorted_hgt import seg_sum_csr
from pyhgt_tpu_torch.sampling.seg_cases import (
    CASES as HARD_CASES, adversarial_auxes, on_nan_memory, segment_sum_f64,
)
from pyhgt_tpu_torch.sampling.sorted_batch import (
    pallas_seg_aux, pallas_tab_window_aux,
)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's kernel module and aux constructors (CPU,
    interpret)."""
    pytest.importorskip("jax")
    from pyhgt_tpu.ops import pallas_seg as jseg
    from pyhgt_tpu.sampling import sorted_batch as jsb

    return jseg, jsb


def _sorted_keys(E, S, n_pad, seed):
    """Sorted segment ids with a padded tail (sentinel S)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, S, size=E - n_pad))
    return np.concatenate([keys, np.full(n_pad, S)]).astype(np.int64)


def _runs_args(capped):
    """pallas_seg_aux arguments: rank-capped W = V (the tiles' measured
    maximum rounded up to 8) or the legacy W = K."""
    E, S = 4 * PK, 300
    keys = _sorted_keys(E, S, 40, 7)
    if not capped:
        return (keys, S, PK, PK), {}
    k2 = keys.reshape(-1, PK)
    v = int((1 + (k2[:, 1:] != k2[:, :-1]).sum(axis=1)).max())
    v = -(-v // 8) * 8
    return (keys, S, PK, v), {"v": v}


def _block_contiguous_tab(B, L, sizes, seed):
    """Table indices ``b*L + dt`` in src order: blocks contiguous, dt in no
    order."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        b * L + rng.integers(0, L, size=s) for b, s in enumerate(sizes)
    ]).astype(np.int64)


# (L, W): the uncompacted table under the default W, and a compact one with
# W = L = 64 as the bench preset's tab_cap gives it
WINDOWS = [pytest.param(240, PK, id="L240-W384"),
           pytest.param(64, 64, id="L64-W64")]
SIZES = [3 * PK + 100, 2 * PK - 100, 3 * PK]


def _pair_data(E, D, dtype, seed=3):
    rng = np.random.default_rng(seed)
    d1 = rng.normal(size=(E, D)).astype(np.float32)
    d2 = rng.normal(size=(E, D)).astype(np.float32)
    tdt = getattr(torch, dtype)
    return d1, d2, torch.from_numpy(d1).to(tdt), torch.from_numpy(d2).to(tdt)


def _same_aux(aux, jaux):
    for f in ("loc", "blk", "ptr2"):
        np.testing.assert_array_equal(getattr(aux, f), getattr(jaux, f))
        assert getattr(aux, f).dtype == getattr(jaux, f).dtype
    assert (aux.w, aux.v) == (jaux.w, jaux.v)


def _tol(dtype):
    # f32: the JAX kernel sums a bf16 hi/lo split of f32 data, accurate to
    # about 2^-16 of each value, the port sums f32 directly. bf16: both sum
    # the same bf16 values in f32; only the order differs.
    return 1e-4 if dtype == "float32" else 1e-5


@pytest.mark.parametrize("capped", [True, False], ids=["capped", "legacy"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_runs_aux_pair_matches_jax_kernel(jax_side, capped, dtype):
    import jax.numpy as jnp

    jseg, jsb = jax_side
    args, kw = _runs_args(capped)
    aux, jaux = pallas_seg_aux(*args, **kw), jsb.pallas_seg_aux(*args, **kw)
    _same_aux(aux, jaux)
    assert not aux.window
    d1, d2, t1, t2 = _pair_data(args[0].shape[0], 128, dtype)
    before = live_partials_pair.launches
    p1, p2 = live_partials_pair(t1, t2, aux.to("cpu"))
    assert live_partials_pair.launches == before  # CPU tensors never launch
    jdt = getattr(jnp, dtype)
    r1, r2 = jseg.live_partials_pair(jnp.asarray(d1, jdt),
                                     jnp.asarray(d2, jdt), jaux)
    for p, r in ((p1, r1), (p2, r2)):
        assert p.dtype == torch.float32 and p.shape == r.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(r),
                                   rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("L,W", WINDOWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_aux_pair_matches_jax_kernel_and_numpy(jax_side, L, W, dtype):
    import jax.numpy as jnp

    jseg, jsb = jax_side
    B = len(SIZES)
    tab = _block_contiguous_tab(B, L, SIZES, 11)
    aux = pallas_tab_window_aux(tab, B, L, PK, W)
    jaux = jsb.pallas_tab_window_aux(tab, B, L, PK, W)
    _same_aux(aux, jaux)
    assert aux.window and aux.live_key is None
    # the window is unsorted within a tile: the single-tensor kernel's
    # contract does not hold for it
    assert np.any(np.diff(aux.loc, axis=1) < 0)
    d1, d2, t1, t2 = _pair_data(tab.shape[0], 128, dtype)
    taux = aux.to("cpu")
    p1, p2 = live_partials_pair(t1, t2, taux)
    jdt = getattr(jnp, dtype)
    r1, r2 = jseg.live_partials_pair(jnp.asarray(d1, jdt),
                                     jnp.asarray(d2, jdt), jaux)
    # rows of the window sum ~25 (L = 64) or ~7 (L = 240) unit normals:
    # compare at their scale
    for p, r, t in ((p1, r1, t1), (p2, r2, t2)):
        assert p.shape == r.shape == (B * W, 128)
        np.testing.assert_allclose(p.numpy(), np.asarray(r),
                                   rtol=_tol(dtype), atol=10 * _tol(dtype))
        # level 2 picks row b*W + dt out for table row b*L + dt
        got = seg_sum_csr(p, taux.ptr2).numpy()
        ref = np.zeros((B * L, 128))
        np.add.at(ref, tab, t.float().numpy().astype(np.float64))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_window_aux_falls_back_to_none_like_jax(jax_side):
    """Interleaved blocks, or blocks smaller than a tile, give no window."""
    _, jsb = jax_side
    rng = np.random.default_rng(5)
    B, L, E = 3, 240, 8 * PK
    mixed = rng.integers(0, B * L, size=E).astype(np.int64)
    tiny = np.concatenate(
        [b * L + rng.integers(0, L, size=PK // 4) for b in range(4)]
        + [3 * L + rng.integers(0, L, size=7 * PK)]).astype(np.int64)
    for tab, nb in ((mixed, B), (tiny, 4)):
        assert pallas_tab_window_aux(tab, nb, L) is None
        assert jsb.pallas_tab_window_aux(tab, nb, L) is None


def _window(loc, blk=(0, 0, 1, 1), window=True):
    """3 tiles of K = 4, W = V = 4 (window 8), NB = 4 - 3 + 1 = 2 blocks."""
    return PallasSegAux(loc=np.array(loc, np.int32),
                        blk=np.array(blk, np.int32),
                        ptr2=np.zeros(1, np.int32), w=4, v=4, window=window)


GOOD = [[3, 0, 2, 0], [1, 7, 0, 4], [3, 3, 0, 1]]


def test_check_rows_accepts_both_kinds():
    check_rows(_window(GOOD))
    args, kw = _runs_args(True)
    check_rows(pallas_seg_aux(*args, **kw))
    # the same unsorted rows are no runs aux
    with pytest.raises(ValueError, match="contract"):
        check_rows(_window(GOOD, window=False))


@pytest.mark.parametrize("loc,blk", [
    ([[3, 0, 2, 0], [1, 8, 0, 4], [3, 3, 0, 1]], (0, 0, 1, 1)),   # loc = W + V
    ([[3, 0, -1, 0], [1, 7, 0, 4], [3, 3, 0, 1]], (0, 0, 1, 1)),  # negative
    ([[3, 0, 2, 0], [1, 3, 0, 2], [3, 3, 0, 1]], (0, 2, 2, 2)),   # blk jumps
    ([[3, 0, 2, 0], [1, 3, 0, 2], [3, 3, 0, 1]], (1, 1, 0, 1)),   # blk goes back
    ([[3, 0, 2, 0], [1, 7, 0, 4], [3, 4, 0, 1]], (0, 0, 1, 1)),   # row 8 of 8
], ids=["past-window", "negative", "block-jump", "block-back", "past-output"])
def test_window_aux_rows_the_kernel_cannot_take_are_rejected(loc, blk):
    with pytest.raises(ValueError, match="window contract"):
        _window(loc, blk).to("cpu")


def test_wrapper_refuses_what_the_kernels_cannot_take():
    aux = _window(GOOD).to("cpu")
    d = torch.zeros(12, 128)
    with pytest.raises(ValueError, match="pair shapes differ"):
        live_partials_pair(d, torch.zeros(12, 64), aux)
    with pytest.raises(ValueError, match="aux tiles"):
        live_partials_pair(torch.zeros(8, 128), torch.zeros(8, 128), aux)
    # the single-tensor kernel walks runs: no window aux
    with pytest.raises(ValueError, match="runs aux"):
        _check(d, aux)
    assert live_partials(d, aux).shape == (8, 128)  # the plain version can


def test_plain_pair_equals_two_singles():
    args, kw = _runs_args(False)
    aux = pallas_seg_aux(*args, **kw).to("cpu")
    _, _, t1, t2 = _pair_data(args[0].shape[0], 128, "float32")
    p1, p2 = live_partials_pair_plain(t1, t2, aux)
    torch.testing.assert_close(p1, live_partials(t1, aux), rtol=0, atol=0)
    torch.testing.assert_close(p2, live_partials(t2, aux), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["runs-capped", "runs-legacy", "window-64",
                                  "window-240"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(kind, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if kind.startswith("runs"):
        args, kw = _runs_args(kind == "runs-capped")
        aux, E = pallas_seg_aux(*args, **kw), args[0].shape[0]
    else:
        L = int(kind.split("-")[1])
        tab = _block_contiguous_tab(3, L, SIZES, 11)
        aux, E = pallas_tab_window_aux(tab, 3, L, PK, L), tab.shape[0]
    gaux = aux.to("cuda")
    _, _, t1, t2 = _pair_data(E, 512, dtype)
    t1, t2 = t1.cuda(), t2.cuda()
    before = live_partials_pair.launches
    got = live_partials_pair(t1, t2, gaux)
    torch.cuda.synchronize()
    assert live_partials_pair.launches == before + 1
    want = live_partials_pair_plain(t1, t2, gaux)
    # the same f32 sums of the same values in another order (atomics on
    # both sides in the window case); the masked tail of a runs aux is one
    # run of up to 384 unit normals per tile
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def hard_auxes():
    return adversarial_auxes(6)


@pytest.mark.parametrize("case", HARD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_pair_on_adversarial_aux_matches_numpy(hard_auxes, case,
                                                     dtype):
    aux = hard_auxes[case]
    check_rows(aux)
    _, _, t1, t2 = _pair_data(aux.loc.size, 64, dtype, seed=13)
    got = live_partials_pair(t1, t2, aux.to("cpu"))
    for g, t in zip(got, (t1, t2)):
        ref, mag = segment_sum_f64(t.float().numpy(), aux)
        # f32 sums of up to 384 terms (a window row: a few hundred more):
        # within (n - 1) 2^-24 of the sum of their magnitudes
        assert np.all(np.abs(g.numpy() - ref) <= 6e-5 * mag + 1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles,wide", [(6, False), (72, False),
                                          (138, False), (6, True)],
                         ids=["6-tiles", "72-tiles", "138-tiles",
                              "6-tiles-wide"])
@pytest.mark.parametrize("case", HARD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["pair", "slab"])
def test_cuda_kernel_on_adversarial_aux(n_tiles, wide, case, dtype, fn):
    """The pair's kernels (and the slab's, which share them) against their
    plain versions on the hard layouts, at tile counts that split a tile
    over 8, 4 and 2 blocks on a 132-SM card (and rows wider than one
    block's 256 column vectors, copied row by row), on outputs whose memory
    held NaN: every row written, the rows no edge reaches exactly 0; a runs
    aux gives bit-identical sums in two calls (a window aux adds with
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gaux = adversarial_auxes(n_tiles)[case].to("cuda")
    # the OAG width for the pair; the slab takes 128-aligned halves
    E, D = gaux.loc.numel(), 2304 if wide else 400 if fn == "pair" else 384
    gen = torch.Generator().manual_seed(n_tiles)
    slab = torch.randn(E, 2 * D, generator=gen).to(getattr(torch, dtype))
    slab = slab.cuda()
    d1, d2 = slab[:, :D].contiguous(), slab[:, D:].contiguous()
    if fn == "pair":
        run = lambda: live_partials_pair(d1, d2, gaux)  # noqa: E731
        want = live_partials_pair_plain(d1, d2, gaux)
    else:
        run = lambda: live_partials_slab(slab, gaux)  # noqa: E731
        want = live_partials_slab_plain(slab, gaux)
    # the two outputs are views of one [2, NB*W, D] allocation
    shape = (2, gaux.num_blocks * gaux.w, D)
    got = on_nan_memory(run, [shape])
    again = on_nan_memory(run, [shape])
    torch.cuda.synchronize()
    reached = torch.zeros(shape[1], dtype=torch.bool, device="cuda")
    rows = out_rows(gaux)
    reached[rows[rows >= 0]] = True
    for g, a, w in zip(got, again, want):
        if not gaux.window:
            assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
        assert not g[~reached].any()
