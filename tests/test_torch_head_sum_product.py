"""The port's ``head_sum_product`` (pyhgt_tpu_torch/ops/pallas_seg.py)
against the JAX package's Pallas kernel.

No path of either package calls this function (the JAX edge stage's
``_head_sum_prod`` drops its kernel flag): it is ported as the standalone
function it is. On the CPU the port's wrapper runs its plain PyTorch version;
the JAX side runs the Pallas kernel in interpret mode (the case of
``tests/test_pallas_seg.py::test_head_sum_product_matches_xla``). The CUDA
kernel is held against the plain version in
``test_cuda_kernel_matches_plain``, which needs the card:

    python -m pytest tests/test_torch_head_sum_product.py -m cuda --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

from pyhgt_tpu_torch.ops.pallas_seg import (
    PK, head_sum_product, head_sum_product_plain,
)


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    from pyhgt_tpu.ops import pallas_seg as jseg

    return jseg


def _data(E, D, seed=21):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(E, D)).astype(np.float32),
            rng.normal(size=(E, D)).astype(np.float32))


@pytest.mark.parametrize("dk", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_and_numpy(jax_side, dk, dtype):
    import jax.numpy as jnp

    E, D = 4 * PK, 256
    a, b = _data(E, D)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    before = head_sum_product.launches
    out = head_sum_product(ta, tb, dk)
    assert head_sum_product.launches == before  # CPU tensors never launch
    jdt = getattr(jnp, dtype)
    ref = np.asarray(jax_side.head_sum_product(
        jnp.asarray(a, jdt), jnp.asarray(b, jdt), dk))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (E, D // dk)
    scale = np.abs(ref).max()
    # both multiply the same values in f32; the JAX kernel sums a bf16 hi/lo
    # split of each product (~2^-16 of it), the port sums f32: 1e-4 of scale
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * scale)
    # and the definition, in f64, on the values as rounded to the dtype
    exact = (ta.double() * tb.double()).reshape(E, D // dk, dk).sum(-1)
    np.testing.assert_allclose(out.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)


def test_argument_checks_match_the_jax_function(jax_side):
    import jax.numpy as jnp

    a, b = _data(PK + 1, 256)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fn, x, y in ((head_sum_product, ta, tb),
                     (jax_side.head_sum_product, jnp.asarray(a),
                      jnp.asarray(b))):
        with pytest.raises(ValueError, match="shapes differ"):
            fn(x[:PK], y[:PK, :128], 32)
        with pytest.raises(ValueError, match="multiple"):
            fn(x, y, 32)                      # E % PK
        with pytest.raises(ValueError, match="multiple"):
            fn(x[:PK], y[:PK], 48)            # D % dk


@pytest.mark.cuda
@pytest.mark.parametrize("dk", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dk, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a, b = _data(4 * PK, 512)
    ta = torch.from_numpy(a).to(getattr(torch, dtype)).cuda()
    tb = torch.from_numpy(b).to(getattr(torch, dtype)).cuda()
    before = head_sum_product.launches
    got = head_sum_product(ta, tb, dk)
    torch.cuda.synchronize()
    assert head_sum_product.launches == before + 1
    # the same f32 products, summed in another order
    torch.testing.assert_close(got, head_sum_product_plain(ta, tb, dk),
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="power of two"):
        head_sum_product(ta[:, :384], tb[:, :384], 96)
