"""The port's ``live_partials_weighted`` (pyhgt_tpu_torch/ops/pallas_seg.py)
against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode (the case of
``tests/test_pallas_seg.py::test_live_partials_weighted_matches_unfused``).
The CUDA kernel is held against the plain version in
``test_cuda_kernel_matches_plain``, which needs the card:

    python -m pytest tests/test_torch_live_partials_weighted.py -m cuda --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.ops.pallas_seg import (
    PK, live_partials, live_partials_weighted, live_partials_weighted_plain,
)
from pyhgt_tpu_torch.ops.sorted_hgt import seg_sum_csr
from pyhgt_tpu_torch.sampling.sorted_batch import pallas_seg_aux

E, S, D, DK = 4 * PK, 300, 256, 64


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    from pyhgt_tpu.ops import pallas_seg as jseg
    from pyhgt_tpu.sampling import sorted_batch as jsb

    return jseg, jsb


def _case(capped):
    rng = np.random.default_rng(23)
    keys = np.sort(rng.integers(0, S, size=E - 40))
    keys = np.concatenate([keys, np.full(40, S)]).astype(np.int64)
    w = rng.random(size=(E, D // DK)).astype(np.float32)
    v = rng.normal(size=(E, D)).astype(np.float32)
    if not capped:
        return keys, w, v, (keys, S, PK, PK), {}
    k2 = keys.reshape(-1, PK)
    cap = int((1 + (k2[:, 1:] != k2[:, :-1]).sum(axis=1)).max())
    cap = -(-cap // 8) * 8
    return keys, w, v, (keys, S, PK, cap), {"v": cap}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(jax_side, dtype):
    """Legacy W = V = K aux: the TPU kernel's retire assumes V = K."""
    import jax.numpy as jnp

    jseg, jsb = jax_side
    keys, w, v, args, kw = _case(capped=False)
    aux, jaux = pallas_seg_aux(*args, **kw), jsb.pallas_seg_aux(*args, **kw)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    before = live_partials_weighted.launches
    out = live_partials_weighted(torch.from_numpy(w), tv, DK, aux.to("cpu"))
    assert live_partials_weighted.launches == before  # CPU: no launch
    ref = np.asarray(jseg.live_partials_weighted(
        jnp.asarray(w), jnp.asarray(v, getattr(jnp, dtype)), DK, jaux))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    scale = np.abs(ref).max()
    if dtype == "float32":
        # the JAX kernel sums a bf16 hi/lo split of each f32 product
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * scale)
    else:
        # bf16 values: the JAX kernel rounds each product to bf16 (a single
        # matmul pass, 2^-9 relative per term); the port keeps the f32
        # product, closer to the exact sum
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-2,
                                   atol=1e-2 * scale)


@pytest.mark.parametrize("capped", [False, True], ids=["legacy", "capped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level2_matches_numpy_segment_sum(capped, dtype):
    keys, w, v, args, kw = _case(capped)
    taux = pallas_seg_aux(*args, **kw).to("cpu")
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    tw = torch.from_numpy(w)
    out = live_partials_weighted(tw, tv, DK, taux)
    got = seg_sum_csr(out, taux.ptr2).numpy()
    msg = np.repeat(w, DK, axis=1).astype(np.float64) * tv.double().numpy()
    ref = np.zeros((S, D))
    np.add.at(ref, keys[keys < S], msg[keys < S])
    # f32 products and sums of ~5 rows per segment, in f64 on the other side
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # the unfused form: the product written out, then live_partials
    unfused = live_partials(tw.repeat_interleave(DK, dim=1) * tv.float(), taux)
    torch.testing.assert_close(out, unfused, rtol=0, atol=0)


def test_wrapper_refuses_bad_shapes(jax_side):
    import jax.numpy as jnp

    jseg, jsb = jax_side
    _, w, v, args, kw = _case(capped=False)
    aux = pallas_seg_aux(*args, **kw).to("cpu")
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    with pytest.raises(ValueError, match="!="):
        live_partials_weighted(tw[:, :2], tv, DK, aux)
    with pytest.raises(ValueError, match="!="):
        jseg.live_partials_weighted(jnp.asarray(w[:, :2]), jnp.asarray(v), DK,
                                    jsb.pallas_seg_aux(*args, **kw))
    with pytest.raises(ValueError, match="aux tiles"):
        live_partials_weighted(tw[:PK], tv[:PK], DK, aux)
    with pytest.raises(ValueError, match="heads"):
        live_partials_weighted(tw, tv, 48, aux)


@pytest.mark.cuda
@pytest.mark.parametrize("capped", [False, True], ids=["legacy", "capped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(capped, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, w, v, args, kw = _case(capped)
    gaux = pallas_seg_aux(*args, **kw).to("cuda")
    tv = torch.from_numpy(v).to(getattr(torch, dtype)).cuda()
    tw = torch.from_numpy(w).cuda()
    before = live_partials_weighted.launches
    got = live_partials_weighted(tw, tv, DK, gaux)
    torch.cuda.synchronize()
    assert live_partials_weighted.launches == before + 1
    # the same f32 products (fused multiply-add in the kernel) summed in
    # another order; the masked tail is one run of up to 384 rows per tile
    torch.testing.assert_close(
        got, live_partials_weighted_plain(tw, tv, DK, gaux),
        rtol=1e-5, atol=1e-4)
