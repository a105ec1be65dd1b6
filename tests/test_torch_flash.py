"""The port's fused attention (K10, ``repro_torch.kernels.flash_attn``)
against the reference's Pallas kernel (interpret mode, as its own tests
run it on the CPU) and its oracle ``repro.kernels.ref.flash_attention``.

On CPU tensors the wrapper runs its plain version. The bars are the
reference test's own (``tests/test_flash_kernel.py``): float32 within
2e-5, bfloat16 within 2e-2 against the Pallas kernel, whose online softmax
sums in another order; float32 within 1e-6 against the oracle, which does
the same math as the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels import flash_attn as jflash
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attn


def _qkv(seed, b, h, kvh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d)))


def _both(x, dtype):
    return jnp.asarray(x).astype(dtype), t(x).to(getattr(torch, dtype))


def _compare(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
def test_flash_matches_reference_kernel(causal, h, kvh):
    q, k, v = _qkv(h, 2, h, kvh, 256, 256, 64)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "float32") for x in (q, k, v))
    ref = jflash.flash_attention(jq, jk, jv, causal=causal, bq=128, bk=128)
    out = flash_attn.flash_attention(tq, tk, tv, causal=causal, bq=128,
                                     bk=128)
    assert out.shape == (2, h, 256, 64) and out.dtype == torch.float32
    _compare(out, ref, 2e-5)
    _compare(out, jref.flash_attention(jq, jk, jv, causal=causal), 1e-6)


def test_flash_local_window():
    q, k, v = _qkv(1, 1, 2, 1, 256, 256, 32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "float32") for x in (q, k, v))
    ref = jflash.flash_attention(jq, jk, jv, causal=True, window=64, bq=64,
                                 bk=64)
    out = flash_attn.flash_attention(tq, tk, tv, causal=True, window=64)
    _compare(out, ref, 2e-5)
    _compare(out, jref.flash_attention(jq, jk, jv, causal=True, window=64),
             1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_flash_rectangular(dtype, tol):
    q, k, v = _qkv(2, 1, 4, 4, 128, 512, 64)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    ref = jflash.flash_attention(jq, jk, jv, causal=False, bq=128, bk=256)
    out = flash_attn.flash_attention(tq, tk, tv, causal=False, bq=128,
                                     bk=256)
    assert out.dtype == getattr(torch, dtype)
    _compare(out, ref, tol)


def test_flash_fully_masked_rows_average_v():
    """Sq = 128 > Sk = 64 with a causal window of 32: rows 95.. see no key;
    the finite -1e30 mask gives them v's uniform mean, not NaN."""
    q, k, v = _qkv(3, 1, 2, 1, 128, 64, 32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "float32") for x in (q, k, v))
    ref = jflash.flash_attention(jq, jk, jv, causal=True, window=32, bq=64,
                                 bk=64)
    out = flash_attn.flash_attention(tq, tk, tv, causal=True, window=32)
    _compare(out, ref, 2e-5)
    seen = flash_attn.visible(128, 64, True, 32)
    empty = ~seen.any(dim=1)
    assert empty.sum() == 33 and bool(empty[95:].all())
    mean = tv.mean(dim=2, keepdim=True).expand(1, 2, 33, 32)
    np.testing.assert_allclose(out[:, :, 95:].numpy(), mean.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_flash_scale_and_refusals():
    q, k, v = _qkv(4, 1, 2, 2, 64, 64, 32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, "float32") for x in (q, k, v))
    for scale in (0.5, 0.0):           # `or`: 0.0 takes the default
        out = flash_attn.flash_attention(tq, tk, tv, softmax_scale=scale)
        _compare(out, jref.flash_attention(jq, jk, jv, softmax_scale=scale),
                 1e-6)
    with pytest.raises(ValueError, match="multiple of KVH"):
        flash_attn.flash_attention(tq, tk[:, :1].repeat(1, 3, 1, 1),
                                   tv[:, :1].repeat(1, 3, 1, 1))
    with pytest.raises(ValueError, match="divide"):
        flash_attn.flash_attention(tq[:, :, :48], tk, tv, bq=32)
