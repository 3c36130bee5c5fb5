"""The port's ``live_partials`` (pyhgt_tpu_torch/ops/pallas_seg.py) against
the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests do.
Both read aux built by their own package from the same keys (and the aux
itself must match bit for bit). The CUDA kernel is held against the plain
version in ``test_cuda_kernel_matches_plain``, which needs the card; the
JAX package is imported inside a fixture, so on the card's machine (which
has no JAX) that test runs alone:

    python -m pytest tests/test_torch_live_partials.py -m cuda --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.ops.pallas_seg import (
    PK, PallasSegAux, _check, check_rows, live_partials, live_partials_plain,
    out_rows,
)
from pyhgt_tpu_torch.ops.sorted_hgt import seg_sum_csr
from pyhgt_tpu_torch.sampling.seg_cases import (
    CASES as HARD_CASES, adversarial_auxes, on_nan_memory, segment_sum_f64,
)
from pyhgt_tpu_torch.sampling.sorted_batch import pallas_seg_aux


def _keys(E, S, n_pad, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, S, size=E - n_pad))
    return np.concatenate([keys, np.full(n_pad, S)]).astype(np.int64)


def _max_live(keys, K=PK):
    k2 = keys.reshape(-1, K)
    return int((1 + (k2[:, 1:] != k2[:, :-1]).sum(axis=1)).max())


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's kernel module and aux constructor (CPU, interpret)."""
    pytest.importorskip("jax")
    from pyhgt_tpu.ops import pallas_seg as jseg
    from pyhgt_tpu.sampling.sorted_batch import pallas_seg_aux as jax_aux

    return jseg, jax_aux


def _aux_args(keys, S, capped):
    """pallas_seg_aux arguments for rank-capped W = V (cap = the tiles'
    measured maximum rounded up to 8) or the legacy W = K."""
    if capped:
        v = -(-_max_live(keys) // 8) * 8
        return (keys, S, PK, v), {"v": v}
    return (keys, S, PK, PK), {}


def _aux_pair(keys, S, capped, jax_aux):
    """(port aux, JAX aux) for the same keys."""
    args, kw = _aux_args(keys, S, capped)
    return pallas_seg_aux(*args, **kw), jax_aux(*args, **kw)


CASES = [
    # (E, S, n_pad): a masked tail, no tail, many tiles per segment
    (4 * PK, 300, 500),
    (4 * PK, 300, 0),
    (8 * PK, 17, 3),
]


@pytest.mark.parametrize("E,S,n_pad", CASES)
@pytest.mark.parametrize("capped", [True, False], ids=["capped", "legacy"])
def test_aux_matches_jax(jax_side, E, S, n_pad, capped):
    keys = _keys(E, S, n_pad, E + S + n_pad)
    aux, jaux = _aux_pair(keys, S, capped, jax_side[1])
    for f in ("loc", "blk", "ptr2", "live_key"):
        np.testing.assert_array_equal(getattr(aux, f), getattr(jaux, f))
        assert getattr(aux, f).dtype == getattr(jaux, f).dtype
    assert (aux.w, aux.v) == (jaux.w, jaux.v)
    if capped:
        assert aux.w == aux.v < PK


@pytest.mark.parametrize("E,S,n_pad", CASES)
@pytest.mark.parametrize("capped", [True, False], ids=["capped", "legacy"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(jax_side, E, S, n_pad, capped, dtype):
    import jax.numpy as jnp

    jseg, jax_aux = jax_side
    keys = _keys(E, S, n_pad, E + S + n_pad)
    aux, jaux = _aux_pair(keys, S, capped, jax_aux)
    rng = np.random.default_rng(7)
    data = rng.normal(size=(E, 128)).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(data).to(tdt)
    before = live_partials.launches
    out = live_partials(xt, aux.to("cpu"))
    assert live_partials.launches == before  # CPU tensors never launch
    ref = np.asarray(jseg.live_partials(jnp.asarray(data, getattr(jnp, dtype)),
                                        jaux))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    if dtype == "float32":
        # the JAX kernel sums a bf16 hi/lo split of f32 data, accurate to
        # about 2^-16 of each value; the port sums f32 directly
        tol = 1e-4
    else:
        # both sum the same bf16 values in f32; only the order differs
        tol = 1e-5
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("capped", [True, False], ids=["capped", "legacy"])
def test_level2_matches_segment_sum_f64(capped):
    E, S, n_pad = 4 * PK, 300, 500
    keys = _keys(E, S, n_pad, 11)
    args, kw = _aux_args(keys, S, capped)
    aux = pallas_seg_aux(*args, **kw)
    data = np.random.default_rng(3).normal(size=(E, 256)).astype(np.float32)
    taux = aux.to("cpu")
    got = seg_sum_csr(live_partials(torch.from_numpy(data), taux), taux.ptr2)
    ref = np.zeros((S, 256))
    valid = keys < S
    np.add.at(ref, keys[valid], data[valid].astype(np.float64))
    # f32 sums of a few N(0, 1) rows and an f32 cumsum-diff over ~400 rows
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def _hand_aux(loc, blk=(0, 1, 2)):
    """2 tiles of K = 4, W = V = 4 (window 8), NB = 3 - 2 + 1 = 2 blocks."""
    return PallasSegAux(loc=np.array(loc, np.int32),
                        blk=np.array(blk, np.int32),
                        ptr2=np.zeros(1, np.int32), w=4, v=4)


def test_plain_sums_runs_into_their_rows():
    aux = _hand_aux([[0, 0, 1, 2], [0, 1, 1, 3]]).to("cpu")
    data = torch.arange(8, dtype=torch.float32)[:, None].repeat(1, 4)
    out = live_partials_plain(data, aux)
    assert out.shape == (8, 4)
    np.testing.assert_array_equal(out[:, 0].numpy(),
                                  [0 + 1, 2, 3, 0, 4, 5 + 6, 0, 7])


@pytest.mark.parametrize("loc,blk", [
    ([[0, 1, 0, 2], [0, 1, 1, 3]], (0, 1, 2)),   # loc decreases in a tile
    ([[-1, 0, 1, 2], [0, 1, 1, 3]], (0, 1, 2)),  # below the window
    ([[0, 0, 1, 2], [0, 1, 1, 8]], (0, 1, 2)),   # past the window W + V
    ([[0, 0, 1, 2], [0, 1, 1, 3]], (0, 0, 2)),   # tiles share rows
    ([[0, 0, 1, 2], [0, 1, 2, 4]], (0, 1, 2)),   # row 8 past the output
], ids=["decreasing", "negative", "past-window", "tiles-overlap",
        "past-output"])
def test_aux_rows_the_kernel_cannot_take_are_rejected(loc, blk):
    with pytest.raises(ValueError, match="contract"):
        _hand_aux(loc, blk).to("cpu")


@pytest.mark.parametrize("bad,err", [
    ("dtype", TypeError), ("width", ValueError), ("rows", ValueError),
    ("loc_dtype", TypeError), ("w_lt_v", ValueError),
    ("unchecked", ValueError),
])
def test_wrapper_checks_reject_bad_inputs(bad, err):
    keys = _keys(2 * PK, 50, 0, 1)
    aux = pallas_seg_aux(keys, 50).to("cpu")
    data = torch.zeros(2 * PK, 128)
    if bad == "dtype":
        data = data.half()
    elif bad == "width":
        data = torch.zeros(2 * PK, 130)
    elif bad == "rows":
        data = torch.zeros(PK, 128)
    elif bad == "loc_dtype":
        aux.loc = aux.loc.long()
    elif bad == "w_lt_v":
        aux.v = aux.w + 8
    elif bad == "unchecked":
        aux.rows_checked = False
    with pytest.raises(err):
        _check(data, aux)


@pytest.mark.cuda
@pytest.mark.parametrize("capped", [True, False], ids=["capped", "legacy"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(capped, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    E, S, n_pad = 16 * PK, 900, 700
    keys = _keys(E, S, n_pad, 5)
    args, kw = _aux_args(keys, S, capped)
    gaux = pallas_seg_aux(*args, **kw).to("cuda")
    x = torch.randn(E, 512, generator=torch.Generator().manual_seed(0))
    x = x.to(getattr(torch, dtype)).cuda()
    before = live_partials.launches
    got = live_partials(x, gaux)
    torch.cuda.synchronize()
    assert live_partials.launches == before + 1
    want = live_partials_plain(x, gaux)
    # same f32 sums of the same values in another order (the plain
    # version's atomics); the masked tail is one run of up to 384 unit
    # normals per tile, whose sum (~20) differs by a few ulps (~2e-6 each)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# the hard layouts of pyhgt_tpu_torch.sampling.seg_cases that a runs walk
# takes (the window case is the pair's)
RUNS_CASES = [c for c in HARD_CASES if c != "window"]


@pytest.fixture(scope="module")
def hard_auxes():
    return adversarial_auxes(6)


@pytest.mark.parametrize("case", RUNS_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_on_adversarial_aux_matches_numpy(hard_auxes, case, dtype):
    aux = hard_auxes[case]
    check_rows(aux)
    E = aux.loc.size
    data = np.random.default_rng(9).normal(size=(E, 64)).astype(np.float32)
    x = torch.from_numpy(data).to(getattr(torch, dtype))
    got = live_partials(x, aux.to("cpu")).numpy()
    ref, mag = segment_sum_f64(x.float().numpy(), aux)
    # f32 sums of up to 384 terms in order: within (n - 1) 2^-24 of the sum
    # of their magnitudes
    assert np.all(np.abs(got - ref) <= 2.5e-5 * mag + 1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles,D", [(6, 400), (72, 400), (138, 400),
                                       (6, 2304)],
                         ids=["6-tiles", "72-tiles", "138-tiles",
                              "6-tiles-wide"])
@pytest.mark.parametrize("case", RUNS_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_on_adversarial_aux(n_tiles, D, case, dtype):
    """The kernel against its plain version on the hard layouts, at tile
    counts that split a tile over 8, 4 and 2 blocks on a 132-SM card (and
    rows wider than one block's 256 column vectors, copied row by row), on
    outputs whose memory held NaN: every row written, the rows no edge
    reaches exactly 0, two calls bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    gaux = adversarial_auxes(n_tiles)[case].to("cuda")
    E = gaux.loc.numel()
    x = torch.randn(E, D, generator=torch.Generator().manual_seed(n_tiles))
    x = x.to(getattr(torch, dtype)).cuda()
    shape = (gaux.num_blocks * gaux.w, D)
    before = live_partials.launches
    got = on_nan_memory(lambda: live_partials(x, gaux), [shape])
    again = on_nan_memory(lambda: live_partials(x, gaux), [shape])
    torch.cuda.synchronize()
    assert live_partials.launches == before + 2
    assert torch.equal(got, again)
    want = live_partials_plain(x, gaux)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    reached = torch.zeros(shape[0], dtype=torch.bool, device="cuda")
    rows = out_rows(gaux)
    reached[rows[rows >= 0]] = True
    assert not got[~reached].any()
