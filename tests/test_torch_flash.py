"""The port's fused attention (K10, ``repro_torch.kernels.flash_attn``)
against the reference's Pallas kernel (interpret mode, as its own tests
run it on the CPU) and its oracle ``repro.kernels.ref.flash_attention``.

On CPU tensors the wrapper runs its plain version. The bars are the
reference test's own (``tests/test_flash_kernel.py``): float32 within
2e-5, bfloat16 within 2e-2 against the Pallas kernel, whose online softmax
sums in another order; float32 within 1e-6 against the oracle, which does
the same math as the plain version. float16 is held within 2.5e-3, eight
times tighter than bfloat16: its 11 significant bits against bfloat16's 8
make both the rounding of P before P V and that of the output eight times
finer.
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


@pytest.mark.parametrize("dtype,d,expected", [
    ("bfloat16", 32, ("wgmma", 128, 128, 3)),
    ("bfloat16", 64, ("wgmma", 128, 128, 3)),
    ("bfloat16", 128, ("wgmma", 128, 128, 2)),
    ("bfloat16", 256, ("wgmma", 128, 64, 2)),
    ("float32", 32, ("wgmma-3xtf32", 128, 64, 2)),
    ("float32", 128, ("wgmma-3xtf32", 128, 32, 1)),
    ("float32", 256, ("ffma", 64, 32, 1)),
    ("float16", 128, ("wgmma", 128, 128, 2)),
    ("bfloat16", 80, ("wgmma", 128, 128, 2)),
    ("float32", 80, ("wgmma-3xtf32", 128, 32, 1)),
    ("bfloat16", 192, ("wgmma", 128, 64, 2)),
    ("float32", 192, ("ffma", 64, 32, 1)),
    ("float16", 8, ("wgmma", 128, 128, 3)),
])
def test_flash_instance_choice(dtype, d, expected):
    """bf16 and float16 run the wgmma kernel at every compiled head dim
    (k/v tiles of 64 keys at D = 256, where O is 128 floats a thread, 3
    stages at D <= 64); float32 the 3xTF32 wgmma kernel (both parts of q
    and of a k and v tile in shared memory: 32 keys and one stage at
    D = 128), and the FFMA kernel at D = 256, whose q parts alone would
    fill a block's shared memory. Another head dim that is a multiple of
    8 runs on the next compiled one (hubert-xlarge's 80 on 128,
    deepseek-v3's 192 on 256)."""
    inst = flash_attn.instance(getattr(torch, dtype), d)
    assert (inst.kernel, inst.bq, inst.bk, inst.stages) == expected
    assert inst.d == next(x for x in flash_attn.HEAD_DIMS if x >= d)


@pytest.mark.parametrize("dtype,d", [("float64", 64), ("bfloat16", 44),
                                     ("float32", 100), ("bfloat16", 512),
                                     ("float16", 264)])
def test_flash_instance_refusals(dtype, d):
    """A dtype without a kernel, a ragged head dim or one past 256 raises,
    naming the roadmap item; nothing falls back."""
    with pytest.raises(NotImplementedError, match="ROADMAP|float16 q"):
        flash_attn.instance(getattr(torch, dtype), d)


@pytest.mark.parametrize("dtype,d,causal,sq,tol", [
    ("float16", 128, True, 256, 2.5e-3),      # olmo-1b's heads in float16
    ("float16", 80, False, 128, 2.5e-3),
    ("bfloat16", 80, False, 256, 2e-2),       # hubert-xlarge's heads
    ("float32", 80, False, 256, 2e-5),
    ("bfloat16", 192, True, 128, 2e-2),       # deepseek-v3's q/k heads
    ("float32", 192, True, 128, 2e-5),
])
def test_flash_new_dtypes_and_head_dims(dtype, d, causal, sq, tol):
    """float16 and the head dims 80 and 192 (no compiled instance of their
    own): the plain version against the reference's Pallas kernel in
    interpret mode, in q's dtype."""
    import jax
    q, k, v = _qkv(d + sq, 1, 4, 2, sq, sq, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    ref = jax.jit(lambda a, b, c: jflash.flash_attention(
        a, b, c, causal=causal, bq=128, bk=128))(jq, jk, jv)
    out = flash_attn.flash_attention(tq, tk, tv, causal=causal, bq=128,
                                     bk=128)
    assert out.shape == (1, 4, sq, d) and out.dtype == getattr(torch, dtype)
    _compare(out, ref, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48)])
def test_flash_sk_not_a_multiple_of_64(dtype, tol, causal, window):
    """Sk = 100 and Sq = 150 (past a 64- and a 128-key tile edge, GQA 4 /
    2): the plain version against the reference kernel with whole-sequence
    blocks and against its oracle."""
    q, k, v = _qkv(5, 1, 4, 2, 150, 100, 64)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    ref = jflash.flash_attention(jq, jk, jv, causal=causal, window=window,
                                 bq=150, bk=100)
    out = flash_attn.flash_attention(tq, tk, tv, causal=causal,
                                     window=window, bq=150, bk=100)
    assert out.shape == (1, 4, 150, 64) and out.dtype == getattr(torch, dtype)
    _compare(out, ref, tol)
    if dtype == "float32":
        _compare(out, jref.flash_attention(jq, jk, jv, causal=causal,
                                           window=window), 1e-6)


# ---------------------------------------------------------------------------
# The 3xTF32 arithmetic of the float32 kernel, modelled in plain torch.
# ---------------------------------------------------------------------------

def _tf32_model(q, k, v, causal, window, passes):
    """The float32 kernel's arithmetic: operands split by a bit mask into
    tf32 hi and lo parts (``flash_attn.tf32_split``), S from three
    products (Qh Kh + Qh Kl + Ql Kh) or, for ``passes=1``, one (Qh Kh),
    the scale, the finite mask and the softmax's unnormalised P in
    float32, P split the same way for P V, l summing the unsplit P."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    (qh, ql), (kh, kl), (vh, vl) = (flash_attn.tf32_split(x)
                                    for x in (q, k, v))

    def qk(x, y):
        return torch.einsum("bkgqd,bkjd->bkgqj",
                            x.reshape(b, kvh, h // kvh, sq, d), y)

    def pv(x, y):
        return torch.einsum("bkgqj,bkjd->bkgqd", x, y)

    s = qk(qh, kh) + qk(qh, kl) + qk(ql, kh) if passes == 3 else qk(qh, kh)
    s = torch.where(flash_attn.visible(sq, sk, causal, window),
                    s / np.sqrt(d), torch.tensor(flash_attn.NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ph, pl = flash_attn.tf32_split(p)
    o = pv(ph, vh) + pv(ph, vl) + pv(pl, vh) if passes == 3 else pv(ph, vh)
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, h, sq, d)


@pytest.mark.parametrize("h,kvh,sq,sk,d,causal,window", [
    (4, 4, 256, 256, 128, True, None),        # olmo-1b's layout, causal
    (4, 4, 256, 256, 64, True, 64),           # windowed
    (8, 2, 192, 192, 128, True, None),        # GQA
    (4, 4, 128, 320, 64, False, None),        # Sq != Sk, full
    (2, 1, 200, 100, 128, True, 48),          # Sq > Sk: rows with no key
])
def test_3xtf32_model_within_the_bar(h, kvh, sq, sk, d, causal, window):
    """Three TF32 products with a truncated (masked) hi part stay within
    the float32 bar, 2e-5, of the plain version on seeded inputs; one TF32
    product does not, which is why the kernel splits every operand."""
    q, k, v = (t(x) for x in _qkv(sq + d, 1, h, kvh, sq, sk, d))
    ref = flash_attn.flash_attention_plain(q, k, v, causal, window)

    def excess(out):
        return float(((out - ref).abs() - 2e-5 * (1 + ref.abs())).max())

    assert excess(_tf32_model(q, k, v, causal, window, 3)) <= 0
    assert excess(_tf32_model(q, k, v, causal, window, 1)) > 0


def test_split_3xtf32_plain_layout():
    """The pre-pass's plain version: hi and lo are tf32 values (13 low
    bits clear) that add up to q and k within 2^-21 relative; v^T's parts
    hold, in each group of 8 columns, keys 0, 2, 4, 6, 1, 3, 5, 7, with
    zeros past Sk up to Skp = Sk rounded to 32."""
    q, k, v = (t(x) for x in _qkv(7, 1, 4, 2, 64, 70, 32))
    qh, ql, kh, kl, vh, vl = flash_attn.split_3xtf32(q, k, v)
    assert vh.shape == vl.shape == (1, 2, 32, 96)
    for x in (qh, ql, kh, kl, vh, vl):
        assert not bool((x.view(torch.int32) & 0x1FFF).any())
    for hi, lo, x in ((qh, ql, q), (kh, kl, k)):
        assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21
    order = flash_attn.key_order(96)
    assert order[:8].tolist() == [0, 2, 4, 6, 1, 3, 5, 7]
    vt = (vh + vl)[..., torch.argsort(order)]
    assert not bool(vt[..., 70:].any())
    np.testing.assert_allclose(vt[..., :70].transpose(2, 3).numpy(),
                               v.numpy(), rtol=2.0 ** -21, atol=0)
