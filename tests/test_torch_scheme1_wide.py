"""Scheme I past float32 / bf16 at p <= 8 in the port, against the JAX
reference, bit for bit:

* float64 operands (carved in float64 with float64 scales) at p = 8, 12
  and 16, and float32 / bf16 at p = 9 and 16, on the 'cuda' backend's
  route with CPU tensors (the kernels' plain versions), against
  ``repro.core.scheme1.matmul`` and the reference's GPU lowerings
  (``gpu.fused_matmul_scheme1`` / ``_batched``) in interpret mode, and
  ``ops.fused_scheme1_matmul`` against the reference's;
* float16 under ozaki1 against the reference's widened route (float32
  slices, the shift-reduce in float16: every op rounded, the weight and
  the scales too, so a slice-product sum past 65504 is inf, as there);
* complex128 under ozaki1 (4M of float64 parts);
* a float64 prepared weight and its twin ('planes' on the 'cuda'
  backend) against the reference's prepared operand;
* the backward: complex under both schemes, where the port's gradient is
  conj(ref_vjp(conj(g))) (``repro_torch.core.emulated``), and float64.

float64 and complex128 are compared inside ``jax.enable_x64(True)``, the
context manager only (tests share worker processes). Inputs are paper
Eq. 19 matrices from seeded numpy. The kernels themselves are held to
these plain versions on the card (tests/test_torch_cuda.py,
``test_scheme1_wide_*``; chip_smoke.py phase 25).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from conftest import conditioned
from repro.core import emulated as jemulated, scheme1 as jscheme1
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import ops as jops, prepared as jprepared
from repro.kernels.backends import gpu as jgpu
from repro.kernels.common import Blocks as JBlocks
from repro_torch.core import emulated as temulated, scheme1
from repro_torch.core.precision import EmulationConfig as TCfg
from repro_torch.kernels import dispatch, ops, ozaki1, prepared


def _same(x: torch.Tensor, y) -> None:
    """Equal bit patterns of a tensor and a jax array (complex by parts)."""
    x = x.detach()
    if x.is_complex():
        x = torch.view_as_real(x)
        y = np.stack([np.real(y), np.imag(y)], axis=-1)
    x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
    y = np.asarray(y)
    if y.dtype == jnp.bfloat16:
        y = y.view(np.int16)
    x = x.numpy()
    assert x.dtype.itemsize == y.dtype.itemsize, (x.dtype, y.dtype)
    if x.dtype.kind == "f":
        x, y = x.view(f"i{x.itemsize}"), y.view(f"i{y.itemsize}")
    np.testing.assert_array_equal(x, y)


def _operands(seed, shape_a, shape_b, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = conditioned(rng, shape_a, dtype=np.float64)
    b = conditioned(rng, shape_b, dtype=np.float64)
    if dtype in (np.complex64, np.complex128):
        a = a + 1j * conditioned(rng, shape_a, dtype=np.float64)
        b = b + 1j * conditioned(rng, shape_b, dtype=np.float64)
    return a.astype(dtype), b.astype(dtype)


def _gpu_ref(a, b, p, out_dtype, blocks, batched=False):
    """The reference's GPU lowering in interpret mode on widened operands
    (its ``_matmul_scheme1`` / ``_batched``)."""
    a, b = jgpu._widen(jnp.asarray(a)), jgpu._widen(jnp.asarray(b))
    beta = JCfg(scheme="ozaki1", p=p).resolved_beta(a.shape[-1])
    mu = jscheme1._pow2_row_scale(a, axis=-1)
    nu = jscheme1._pow2_row_scale(b, axis=-2)
    fn = (jgpu.fused_matmul_scheme1_batched if batched
          else jgpu.fused_matmul_scheme1)
    return fn(a, b, mu, nu, p, beta, blocks, out_dtype=out_dtype)


@pytest.mark.parametrize("p", [8, 12, 16])
def test_float64_cuda_route_matches_reference(p):
    """float64 (48, 96) @ (96, 32): the 'cuda' backend's route (the encode
    and plane GEMM's plain versions) == scheme1.matmul == the GPU
    lowering; the planes carry float64 slices past float32's mantissa."""
    a, b = _operands(p, (48, 96), (96, 32))
    out = dispatch.emulated_matmul(t(a), t(b), cfg=f"ozaki1-p{p}",
                                   backend="cuda")
    assert out.dtype == torch.float64
    with jax.enable_x64(True):
        _same(out, jscheme1.matmul(jnp.asarray(a), jnp.asarray(b),
                                   JCfg(scheme="ozaki1", p=p)))
        _same(out, _gpu_ref(a, b, p, jnp.float64, JBlocks(16, 32, 96)))
    assert np.abs(out.numpy() - a @ b).max() < 1e-9 * np.abs(a @ b).max()


def test_float64_front_doors_match_reference():
    """ops.fused_scheme1_matmul (both decomps) at p = 12 and the batched
    front door at p = 12 against the reference's, in float64."""
    a, b = _operands(20, (128, 128), (128, 128))
    cfg = TCfg(scheme="ozaki1", p=12)
    outs = [ops.fused_scheme1_matmul(t(a), t(b), dataclasses.replace(
        cfg, decomp=d), out_dtype=torch.float64) for d in ("kernel", "xla")]
    a3, b3 = _operands(21, (2, 16, 32), (2, 32, 16))
    out3 = dispatch.emulated_matmul_batched(t(a3), t(b3), cfg="ozaki1-p12",
                                            backend="cuda")
    with jax.enable_x64(True):
        ref = jops.fused_scheme1_matmul(jnp.asarray(a), jnp.asarray(b),
                                        JCfg(scheme="ozaki1", p=12),
                                        out_dtype=jnp.float64)
        for out in outs:
            _same(out, ref)
        _same(out3, _gpu_ref(a3, b3, 12, jnp.float64, JBlocks(16, 16, 32),
                             batched=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [9, 16])
def test_narrow_types_at_large_p_match_reference(dtype, p):
    """float32 and bf16 at p = 9 and 16 (past the instances of p <= 8),
    2-D (and batched at p = 16), against scheme1.matmul and the GPU
    lowerings."""
    a, b = _operands(30 + p, (32, 80), (80, 48), np.float32)
    ja, jb = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    ta, tb = t(np.asarray(ja.astype(jnp.float32))).to(getattr(torch, dtype)), \
        t(np.asarray(jb.astype(jnp.float32))).to(getattr(torch, dtype))
    out = dispatch.emulated_matmul(ta, tb, cfg=f"ozaki1-p{p}", backend="cuda")
    _same(out, jscheme1.matmul(ja, jb, JCfg(scheme="ozaki1", p=p)))
    _same(out, _gpu_ref(ja, jb, p, jnp.dtype(dtype), JBlocks(16, 16, 80)))
    if p < 16:
        return
    out3 = dispatch.emulated_matmul_batched(
        ta.reshape(2, 16, 80), tb[None].expand(2, 80, 48), cfg=f"ozaki1-p{p}",
        backend="cuda")
    _same(out3, _gpu_ref(ja.reshape(2, 16, 80),
                         jnp.broadcast_to(jb, (2, 80, 48)), p,
                         jnp.dtype(dtype), JBlocks(16, 16, 80), batched=True))


def test_float16_under_ozaki1_matches_widened_reference():
    """float16 operands under ozaki1 on the 'cuda' backend (widened to
    float32 on entry, output float16) == the 'torch' backend == the
    reference's widened GPU lowering, inf and NaN included, 2-D and
    batched."""
    a, b = _operands(40, (32, 64), (64, 32), np.float16)
    outs = [dispatch.emulated_matmul(t(a), t(b), cfg="ozaki1-p4",
                                     backend=bk) for bk in ("cuda", "torch")]
    ref = _gpu_ref(a, b, 4, jnp.float16, JBlocks(16, 16, 64))
    for out in outs:
        assert out.dtype == torch.float16
        _same(out, ref)
    assert not np.isfinite(np.asarray(ref, np.float32)).all()
    a3, b3 = _operands(41, (2, 16, 64), (2, 64, 16), np.float16)
    out3 = dispatch.emulated_matmul_batched(t(a3), t(b3), cfg="ozaki1-p4",
                                            backend="cuda")
    _same(out3, _gpu_ref(a3, b3, 4, jnp.float16, JBlocks(16, 16, 64),
                         batched=True))


def test_float16_under_ozaki2_raises_on_the_cuda_backend():
    """float16 under ozaki2 on the 'cuda' backend no longer raises: it
    runs Scheme II at the 11-bit budget and equals the 'torch' backend
    (tests/test_torch_scheme2_f16.py holds both to the reference)."""
    h = torch.ones(8, 16, dtype=torch.float16)
    outs = [dispatch.emulated_matmul(h, h.T, cfg="ozaki2-m8", backend=bk,
                                     out_dtype=torch.float32)
            for bk in ("cuda", "torch")]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], torch.full((8, 8), 16.0))


def test_complex128_4m_matches_reference():
    """complex128 under ozaki1-p8: four float64 products (4M) on both
    backends == the reference's matmul_complex_4m."""
    a, b = _operands(50, (24, 72), (72, 20), np.complex128)
    outs = [dispatch.emulated_matmul(t(a), t(b), cfg="ozaki1-p8", backend=bk)
            for bk in ("cuda", "torch")]
    with jax.enable_x64(True):
        ref = jscheme1.matmul_complex_4m(jnp.asarray(a), jnp.asarray(b),
                                         JCfg(scheme="ozaki1", p=8))
        for out in outs:
            assert out.dtype == torch.complex128
            _same(out, ref)


def test_float64_prepared_weight_and_twin_match_reference():
    """A float64 weight prepared at p = 12 on the 'cuda' backend (the
    planes of B^T and of B, float64 scales) holds the reference's slices
    and scales, and its forward and twin products equal the reference's
    prepared products."""
    a, w = _operands(60, (40, 96), (96, 56))
    g, _ = _operands(61, (40, 56), (1, 1))
    cfg = TCfg(scheme="ozaki1", p=12, backend="cuda")
    prep = prepared.prepare_rhs(t(w), cfg, with_twin=True)
    assert prep.layout == prep.twin.layout == "planes"
    assert prep.scale.dtype == prep.twin.scale.dtype == torch.float64
    out = prepared.matmul_prepared(t(a), prep, torch.float64)
    da = prepared.matmul_prepared(t(g), prep.twin, torch.float64)
    with jax.enable_x64(True):
        jprep = jprepared.prepare_rhs(jnp.asarray(w),
                                      JCfg(scheme="ozaki1", p=12),
                                      with_twin=True)
        for mine, ref, (k, n) in ((prep, jprep, (96, 56)),
                                  (prep.twin, jprep.twin, (56, 96))):
            np.testing.assert_array_equal(
                mine.stacked()[:, :k, :n].numpy(),
                np.asarray(ref.stacked())[:, :k, :n])
            _same(mine.scale, ref.scale[:, :n])
        _same(out, jprepared.matmul_prepared(jnp.asarray(a), jprep,
                                             out_dtype=jnp.float64))
        _same(da, jprepared.matmul_prepared(jnp.asarray(g), jprep.twin,
                                            out_dtype=jnp.float64))


def _vjp_pair(jcfg, tcfg, a, b, g):
    """(the reference's VJP of conj(g), conjugated; the port's autograd
    gradients), for emulated_dot. The reference runs under jit: one
    compile instead of one per eager op (the same ops, so the same
    bits)."""
    def ref_vjp(x, y, cot):
        return jax.vjp(lambda u, v: jemulated.emulated_dot(u, v, jcfg),
                       x, y)[1](cot)
    with jax.enable_x64(True):
        ref = [np.conj(np.asarray(r)) for r in jax.jit(ref_vjp)(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(np.conj(g)))]
    ta, tb = t(a).requires_grad_(True), t(b).requires_grad_(True)
    temulated.emulated_dot(ta, tb, tcfg).backward(t(g))
    return ref, (ta.grad, tb.grad)


@pytest.mark.parametrize("spec,dtype", [
    (dict(scheme="ozaki1", p=3), np.complex64),
    (dict(scheme="ozaki1", p=4), np.complex128),
    (dict(scheme="ozaki2", p=6), np.complex64),
    (dict(scheme="ozaki2", p=8), np.complex128)])
def test_complex_backward_is_conj_of_reference_vjp(spec, dtype):
    """PyTorch's complex gradient of the emulated product ==
    conj(ref_vjp(conj(g))) (the reference's VJP on its plain expansion,
    which its tests hold equal to its kernels), leading dims in a."""
    a, b = _operands(70, (2, 12, 40), (40, 24), dtype)
    g, _ = _operands(71, (2, 12, 24), (1, 1), dtype)
    ref, ours = _vjp_pair(JCfg(impl="xla", **spec), TCfg(**spec), a, b, g)
    for r, o in zip(ref, ours):
        assert o.dtype == t(a).dtype
        _same(o, r)


@pytest.mark.parametrize("spec", [dict(scheme="ozaki1", p=8),
                                  dict(scheme="ozaki1", p=12,
                                       cache_weights=True),
                                  dict(scheme="ozaki2", p=12)])
def test_float64_backward_matches_reference(spec):
    """float64 gradients through the autograd Functions (the cached one
    through the twin) == the reference's VJP under x64."""
    a, b = _operands(80, (2, 12, 40), (40, 24))
    g, _ = _operands(81, (2, 12, 24), (1, 1))
    ref, ours = _vjp_pair(JCfg(**spec), TCfg(**spec), a, b, g)
    for r, o in zip(ref, ours):
        assert o.dtype == torch.float64
        _same(o, r)


def test_scheme1_limits_and_residual_bound():
    """p runs to 16 on every route; the residual bound is the reference's."""
    assert ozaki1.MAX_P == 16 and ozaki1.batched_tile_n(64, 12) == 16
    assert (scheme1.decomposition_residual_bound(4, 7)
            == jscheme1.decomposition_residual_bound(4, 7))
    x = torch.tensor([[0.3, -0.7, 0.123456789]], dtype=torch.float64)
    sl, scale = scheme1.split(x, 16, 7, axis=-1)
    back = sum(2.0 ** (-7 * (i + 1)) * sl[i].double() for i in range(16))
    assert (x - scale * back).abs().max() <= (
        scale * scheme1.decomposition_residual_bound(16, 7)).max()
