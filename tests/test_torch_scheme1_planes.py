"""EmuGEMM-I's plane route (repro_torch.kernels.ozaki1.encode_planes /
plane_matmul and the 2-D and mixed routes built on them, the 'planes'
layout of a Scheme-I prepared weight) against the reference's Pallas
kernels in interpret mode (repro.kernels.ozaki1.fused_matmul_prologue and
fused_matmul_mixed, repro.kernels.backends.gpu.fused_matmul_scheme1), as
the reference's own tests run them on the CPU.

The port's wrappers run their plain versions on CPU tensors; the kernels
themselves are held to those plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py). The reference kernels need
shapes aligned to their blocks: ragged operands are zero-padded for them
(a zero element carves to zero slices) with the scales of the unpadded
operands, and their result is cut back. Tolerance: none, bit for bit,
float32 and bfloat16 in and out.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import bits, t
from repro.core import scheme1 as jscheme1
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import ozaki1 as jozaki1, prepared as jprepared
from repro.kernels.backends import gpu as jgpu
from repro.kernels.common import Blocks as JBlocks, carve_slices
from repro_torch.core import scheme1
from repro_torch.core.precision import EmulationConfig as TCfg
from repro_torch.kernels import decompose, ozaki1, prepared as tprepared

BLOCKS = JBlocks(32, 32, 32)
# (M, K, N, B read transposed): aligned, ragged in every dim, a transposed
# ragged weight (emb.T), and serving's few rows.
SHAPES = [(32, 64, 64, False), (37, 100, 29, False), (40, 70, 33, True),
          (4, 96, 64, True)]


def _conditioned(seed, shape, phi=2.0):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) - 0.5)
            * np.exp(phi * rng.standard_normal(shape))).astype(np.float32)


def _operands(seed, m, k, n, transposed, dtype):
    """a (M, K) and b (K, N) (a transposed view of an (N, K) table when
    ``transposed``), rounded to ``dtype``, as torch tensors."""
    a = t(_conditioned(seed, (m, k))).to(dtype)
    if transposed:
        b = t(_conditioned(seed + 1, (n, k))).to(dtype).T
    else:
        b = t(_conditioned(seed + 1, (k, n))).to(dtype)
    return a, b


def _jax(x: torch.Tensor, rows: int, cols: int, fill=0.0):
    """A 2-D tensor as a jax array zero-padded (or ``fill``-padded) to
    (rows, cols), in its own float type."""
    dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[x.dtype]
    r, c = x.shape
    out = np.full((rows, cols), fill, np.float32)
    out[:r, :c] = x.float().numpy()
    return jnp.asarray(out).astype(dt)


def _up(x: int) -> int:
    return -(-x // 32) * 32


def _plane_route(a, b, mu, nu, p, beta, out_dtype):
    """The 2-D route of the CUDA backend, each step on its plain version:
    encode A, encode B^T, the plane GEMM."""
    return ozaki1.plane_matmul(ozaki1.encode_planes(a, mu, p, beta),
                               ozaki1.encode_planes(b.T, nu.T, p, beta), mu,
                               nu, p, beta, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_encode_planes_plain_is_the_carve_of_the_padded_operand(p, dtype,
                                                               out_dtype):
    """The planes are scheme1.carve of x / scale, K padded with zero
    slices to PLANE_K; a transposed view encodes as its copy does."""
    x = t(_conditioned(p, (40, 70))).to(dtype)
    scale = scheme1.pow2_scale(x, -1)
    planes = ozaki1.encode_planes_plain(x, scale, p, 6)
    assert planes.shape == (p, 40, 128) and planes.dtype == torch.int8
    want = torch.stack(scheme1.carve(scheme1.widen(x) / scale, p, 6))
    assert torch.equal(planes[:, :, :70], want)
    assert not planes[:, :, 70:].any()
    xt = t(_conditioned(p, (70, 40))).to(dtype).T
    assert torch.equal(ozaki1.encode_planes(xt, scheme1.pow2_scale(xt, -1),
                                            p, 6),
                       ozaki1.encode_planes_plain(
                           xt.contiguous(), scheme1.pow2_scale(xt, -1), p, 6))
    # The plane GEMM's plain version on them is the fused plain version.
    b = t(_conditioned(p + 9, (70, 24))).to(dtype)
    nu = scheme1.pow2_scale(b, -2)
    assert torch.equal(
        _plane_route(x, b, scale, nu, p, 6, out_dtype),
        ozaki1.fused_matmul_plain(x, b, scale, nu, p, 6, out_dtype))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [1, 3, 4, 8])
@pytest.mark.parametrize("m,k,n,transposed", SHAPES)
def test_2d_route_matches_reference_kernels(m, k, n, transposed, p, dtype,
                                            out_dtype):
    tdt, odt = getattr(torch, dtype), getattr(torch, out_dtype)
    a, b = _operands(m * k + p, m, k, n, transposed, tdt)
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    beta = TCfg(scheme="ozaki1", p=p).resolved_beta(k)
    out = _plane_route(a, b, mu, nu, p, beta, odt)
    assert out.dtype == odt and out.shape == (m, n)
    mp, kp, np_ = _up(m), _up(k), _up(n)
    ja, jb = _jax(a, mp, kp), _jax(b, kp, np_)
    jmu = jnp.asarray(_jax(mu.float(), mp, 1, 1.0), jnp.float32)
    jnu = jnp.asarray(_jax(nu.float(), 1, np_, 1.0), jnp.float32)
    jodt = getattr(jnp, out_dtype)
    for ref in (jozaki1.fused_matmul_prologue(ja, jb, jmu, jnu, p, beta,
                                              BLOCKS, out_dtype=jodt),
                jgpu.fused_matmul_scheme1(ja, jb, jmu, jnu, p, beta, BLOCKS,
                                          out_dtype=jodt)):
        np.testing.assert_array_equal(
            bits(out), bits(np.asarray(ref.astype(jnp.float32))[:m, :n]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [1, 3, 4, 8])
@pytest.mark.parametrize("m,k,n,transposed", SHAPES[1:])
def test_mixed_route_matches_reference_kernel(m, k, n, transposed, p, dtype):
    """The lhs encoded against the weight's B^T planes (the 'planes'
    prep's layout) == the reference's mixed kernel on its interleaved
    weight, and == the 'interleaved' layout's plain version."""
    tdt = getattr(torch, dtype)
    a, b = _operands(m + k * p, m, k, n, transposed, tdt)
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    beta = TCfg(scheme="ozaki1", p=p).resolved_beta(k)
    planes = ozaki1.encode_planes(b.T, nu.T, p, beta)
    assert planes.shape == (p, n, ozaki1.plane_k(k))
    out = ozaki1.fused_matmul_mixed(a, planes, mu, nu, p, beta, tdt)
    b_hat = decompose.decompose_rhs_plain(b, nu, p, beta)
    assert torch.equal(out, ozaki1.fused_matmul_mixed_plain(
        a, b_hat, mu, nu, p, beta, tdt))
    mp, kp, np_ = _up(m), _up(k), _up(n)
    jb = _jax(b, kp, np_)
    jnu = jnp.asarray(_jax(nu.float(), 1, np_, 1.0), jnp.float32)
    sl = carve_slices(jb.astype(jnp.float32) / jnu, p, beta)
    jb_hat = jscheme1.interleave_k(jnp.stack(list(sl)), "b", BLOCKS.bk)
    jmu = jnp.asarray(_jax(mu.float(), mp, 1, 1.0), jnp.float32)
    ref = jozaki1.fused_matmul_mixed(_jax(a, mp, kp), jb_hat, jmu, jnu, p,
                                     beta, BLOCKS, out_dtype=getattr(jnp,
                                                                    dtype))
    np.testing.assert_array_equal(
        bits(out), bits(np.asarray(ref.astype(jnp.float32))[:m, :n]))


@pytest.mark.parametrize("beta", [3, 5, 7])
def test_explicit_beta(beta):
    """beta as the caller passes it (not the K-derived default)."""
    a, b = _operands(beta, 37, 100, 29, True, torch.float32)
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    out = _plane_route(a, b, mu, nu, 4, beta, torch.float32)
    ja, jb = _jax(a, 64, 128), _jax(b, 128, 32)
    jmu = jnp.asarray(_jax(mu, 64, 1, 1.0))
    jnu = jnp.asarray(_jax(nu, 1, 32, 1.0))
    ref = jozaki1.fused_matmul_prologue(ja, jb, jmu, jnu, 4, beta, BLOCKS)
    np.testing.assert_array_equal(bits(out),
                                  bits(np.asarray(ref)[:37, :29]))


def test_diagonal_sums_wrap_int32_as_the_reference():
    """A diagonal of s + 1 slice products can pass 2^31 (beta = 7, K large):
    the plane GEMM's plain version wraps as the reference's int32
    accumulators do."""
    k, p, beta = 50688, 4, 7
    rng = np.random.default_rng(5)
    a_sl = rng.integers(120, 128, (p, 2, k)).astype(np.int8)
    b_sl = rng.integers(120, 128, (p, 3, k)).astype(np.int8)
    kp = ozaki1.plane_k(k)
    pad = ((0, 0), (0, 0), (0, kp - k))
    mu = torch.tensor([[2.0], [0.5]])
    nu = torch.tensor([[1.0, 4.0, 0.25]])
    out = ozaki1.plane_matmul(t(np.pad(a_sl, pad)), t(np.pad(b_sl, pad)), mu,
                              nu, p, beta, torch.float32)
    accs = jscheme1.triangular_accumulators(
        jnp.asarray(a_sl), jnp.asarray(b_sl).transpose(0, 2, 1), p)
    assert int(np.asarray(accs[3]).min()) < 0      # the sums did wrap
    ref = jscheme1.shift_reduce(accs, beta, jnp.asarray(mu.numpy()),
                                jnp.asarray(nu.numpy()), jnp.float32)
    np.testing.assert_array_equal(bits(out), bits(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,bwd_p", [(3, 0), (4, 0), (6, 3)])
@pytest.mark.parametrize("k,n", [(128, 256), (100, 72)])
def test_cuda_prep_holds_planes_equal_to_reference(dtype, p, bwd_p, k, n):
    """A 'cuda'-backend prep built on CPU tensors holds the planes of B^T
    (and its twin those of B); stacked() equals the reference's
    prepare_rhs, and matmul_prepared equals the 'interleaved' prep's."""
    x = _conditioned(k * n + p, (k, n), phi=3.0)
    jb = jnp.asarray(x).astype(dtype)
    tb = t(x).to(getattr(torch, dtype))
    kw = dict(scheme="ozaki1", p=p, bwd_p=bwd_p, cache_weights=True)
    jp = jprepared.prepare_rhs(jb, JCfg(**kw), with_twin=True)
    tp = tprepared.prepare_rhs(tb, TCfg(**kw, backend="cuda"),
                               with_twin=True)
    ti = tprepared.prepare_rhs(tb, TCfg(**kw, backend="torch"),
                               with_twin=True)
    assert (tp.layout, tp.twin.layout, ti.layout) == ("planes", "planes",
                                                      "interleaved")
    assert tp.slices.shape == (p, n, ozaki1.plane_k(k))
    assert tp.twin.slices.shape == (bwd_p or p, k, ozaki1.plane_k(n))
    for ours, mine, ref, rows, cols in ((tp, ti, jp, k, n),
                                        (tp.twin, ti.twin, jp.twin, n, k)):
        st = ours.stacked()
        assert torch.equal(st, mine.stacked())
        np.testing.assert_array_equal(
            st[:, :rows, :cols].numpy(),
            np.asarray(ref.stacked())[:, :rows, :cols])
        assert not st[:, rows:].any()
        np.testing.assert_array_equal(
            bits(ours.scale), bits(np.asarray(ref.scale, np.float32)[:, :cols]))
        assert torch.equal(ours.reconstruct(), mine.reconstruct())
    a = t(_conditioned(p + 1, (37, k))).to(getattr(torch, dtype))
    g = t(_conditioned(p + 2, (37, n))).to(getattr(torch, dtype))
    for lhs, ours, mine in ((a, tp, ti), (g, tp.twin, ti.twin)):
        assert torch.equal(tprepared.matmul_prepared(lhs, ours),
                           tprepared.matmul_prepared(lhs, mine))


def test_planes_prep_refuses_another_granularity():
    prep = tprepared.prepare_rhs(t(_conditioned(0, (64, 32))),
                                 TCfg(scheme="ozaki1", p=4, backend="cuda"))
    assert prep.blocks.bk == ozaki1.PLANE_K
    bad = dataclasses.replace(prep, blocks=tprepared.KERNEL_BLOCKS)
    with pytest.raises(ValueError, match="granularity"):
        tprepared.matmul_prepared(t(_conditioned(1, (4, 64))), bad)
    with pytest.raises(ValueError, match="expected int8"):
        ozaki1.fused_matmul_mixed(t(_conditioned(1, (4, 64))),
                                  prep.slices[:, :, :64], t(np.ones((4, 1),
                                                                  np.float32)),
                                  prep.scale, 4, 7, torch.float32)
