"""EmuGEMM-I's interleaved form on the plane route and its batched form,
against the reference's Pallas kernels in interpret mode, as the
reference's own tests run them on the CPU:

* the relayout of A-hat and B-hat into the plane GEMM's planes
  (``ozaki1.relayout_interleaved_plain``) and the route built on it
  (relayout, then ``ozaki1.plane_matmul_plain``) against
  ``ozaki1.fused_matmul_interleaved_plain`` and
  ``repro.kernels.ozaki1.fused_matmul_interleaved``;
* the batched front door (``ozaki1.fused_matmul_scheme1`` on (B, M, K) @
  (B, K, N) CPU tensors, operands read through their strides) against
  ``repro.kernels.backends.gpu.fused_matmul_scheme1_batched``.

The port's wrappers run their plain versions on CPU tensors; the kernels
themselves (the relayout, the plane GEMM, the batched kernel) are held to
those plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py). Sizes are aligned to the reference's blocks. Tolerance:
none, bit for bit, float32 and bfloat16 out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import bits, t
from repro.core import scheme1 as jscheme1
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import ozaki1 as jozaki1
from repro.kernels.backends import gpu as jgpu
from repro.kernels.common import Blocks as JBlocks
from repro_torch.core import scheme1
from repro_torch.kernels import decompose, ozaki1


def _conditioned(seed, shape, phi=2.0):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) - 0.5)
            * np.exp(phi * rng.standard_normal(shape))).astype(np.float32)


def _interleaved(seed, m, k, n, p):
    """A-hat, B-hat, mu, nu and beta of conditioned (M, K) @ (K, N)
    operands, sliced and interleaved at ``decompose.TILE`` by the
    reference, as numpy arrays."""
    a, b = _conditioned(seed, (m, k)), _conditioned(seed + 1, (k, n))
    beta = JCfg(scheme="ozaki1", p=p).resolved_beta(k)
    a_sl, mu = jscheme1.split(jnp.asarray(a), p, beta, axis=1)
    b_sl, nu = jscheme1.split(jnp.asarray(b), p, beta, axis=0)
    a_hat = jscheme1.interleave_k(a_sl, "a", decompose.TILE)
    b_hat = jscheme1.interleave_k(b_sl, "b", decompose.TILE)
    return (np.asarray(a_hat), np.asarray(b_hat), np.asarray(mu),
            np.asarray(nu), beta)


@pytest.mark.parametrize("p", [1, 3, 5])
def test_relayout_plain_writes_the_plane_layout(p):
    """The relayout's plain version: A-hat's slices as K-contiguous planes
    (p, M, Kp') and B-hat's as B^T's (p, N, Kp'), zero past Kp, equal to
    the reference's deinterleaved slices."""
    m, k, n = 24, 160, 40
    a_hat, b_hat, _, _, _ = _interleaved(p, m, k, n, p)
    kpp = ozaki1.plane_k(k)
    pa = ozaki1.relayout_interleaved(t(a_hat), p, "a")
    pb = ozaki1.relayout_interleaved(t(b_hat), p, "b")
    assert pa.shape == (p, m, kpp) and pb.shape == (p, n, kpp)
    assert pa.dtype == pb.dtype == torch.int8
    a_sl = np.asarray(jscheme1.deinterleave_k(jnp.asarray(a_hat), p, "a",
                                              decompose.TILE))
    b_sl = np.asarray(jscheme1.deinterleave_k(jnp.asarray(b_hat), p, "b",
                                              decompose.TILE))
    np.testing.assert_array_equal(pa[:, :, :k].numpy(), a_sl)
    np.testing.assert_array_equal(pb[:, :, :k].numpy(),
                                  b_sl.transpose(0, 2, 1))
    assert not pa[:, :, k:].any() and not pb[:, :, k:].any()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [2, 4, 6])
def test_interleaved_route_matches_reference(out_dtype, p):
    """Relayouts + plane GEMM (their plain versions) == the interleaved
    form's plain version == the reference's Pallas kernel, bit for bit."""
    m, k, n = 64, 96, 64
    a_hat, b_hat, mu, nu, beta = _interleaved(10 + p, m, k, n, p)
    jdt = getattr(jnp, out_dtype)
    kern = jozaki1.fused_matmul_interleaved(
        jnp.asarray(a_hat), jnp.asarray(b_hat), jnp.asarray(mu),
        jnp.asarray(nu), p, beta, JBlocks(32, 32, decompose.TILE),
        out_dtype=jdt)
    tdt = getattr(torch, out_dtype)
    route = ozaki1.plane_matmul_plain(
        ozaki1.relayout_interleaved_plain(t(a_hat), p, "a"),
        ozaki1.relayout_interleaved_plain(t(b_hat), p, "b"), t(mu), t(nu),
        p, beta, tdt)
    plain = ozaki1.fused_matmul_interleaved_plain(t(a_hat), t(b_hat), t(mu),
                                                  t(nu), p, beta, tdt)
    assert route.dtype == tdt
    np.testing.assert_array_equal(bits(route), bits(plain))
    np.testing.assert_array_equal(bits(route),
                                  bits(np.asarray(kern, np.float32)))


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_front_door_matches_reference(dtype, layout):
    """The batched form (B, M, K) @ (B, K, N) on CPU tensors == the
    reference's batched GPU lowering in interpret mode, bit for bit; the
    'strided' operands are a transposed view (A) and a slice of a longer
    buffer (B), as attention's caches arrive."""
    batch, m, k, n, p = 3, 32, 64, 32, 4
    beta = JCfg(scheme="ozaki1", p=p).resolved_beta(k)
    a = t(_conditioned(1, (batch, m, k))).to(dtype)
    b = t(_conditioned(2, (batch, k, n))).to(dtype)
    ta, tb = a, b
    if layout == "strided":
        ta = a.transpose(1, 2).contiguous().transpose(1, 2)
        tb = torch.cat([b, torch.zeros_like(b[:, :5])], 1)[:, :k]
    mu, nu = scheme1.pow2_scale(ta, -1), scheme1.pow2_scale(tb, -2)
    out = ozaki1.fused_matmul_scheme1(ta, tb, mu, nu, p, beta, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    kern = jgpu.fused_matmul_scheme1_batched(
        jnp.asarray(a.float().numpy()), jnp.asarray(b.float().numpy()),
        jnp.asarray(mu.numpy()), jnp.asarray(nu.numpy()), p, beta,
        JBlocks(32, 32, 32), out_dtype=jdt)
    assert out.shape == (batch, m, n) and out.dtype == dtype
    np.testing.assert_array_equal(bits(out), bits(np.asarray(kern,
                                                             np.float32)))
