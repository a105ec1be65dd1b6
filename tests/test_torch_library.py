"""The port's library kernels and entry points against the reference:
the lhs interleave layout, K11 (``decompose.decompose_interleave``), K8
(``ozaki1.fused_matmul_interleaved``), K9 (``matmul_int8.int8_matmul``),
``ops.fused_scheme1_matmul`` on both decomposition routes, and the package
surface (``repro_torch`` and ``repro_torch.kernels``).

The reference's Pallas kernels run in interpret mode here, as its own
tests run them on the CPU; the port's wrappers run their plain versions on
CPU tensors. The emulation interior is exact integer arithmetic, so
slices, int32 products and float32 results are compared bit for bit.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from _torch_util import bits, t
from repro.core import scheme1 as jscheme1
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import decompose as jdecompose
from repro.kernels import matmul_int8 as jmatmul_int8
from repro.kernels import ops as jops
from repro.kernels import ozaki1 as jozaki1
from repro.kernels import ref as jref
from repro.kernels.common import Blocks as JBlocks
from repro_torch import kernels as tkernels
from repro_torch.core import scheme1
from repro_torch.core.precision import EmulationConfig as TCfg
from repro_torch.kernels import (decompose, dispatch, matmul_int8, ops,
                                 ozaki1)
from repro_torch.kernels.backends.cuda import KERNEL_BLOCKS


def _conditioned(seed, shape, phi=2.0):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) - 0.5)
            * np.exp(phi * rng.standard_normal(shape))).astype(np.float32)


def _int8(seed, shape):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(
        np.int8)


# ---------------------------------------------------------------------------
# The interleaved layouts.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("operand,shape", [("a", (3, 7, 64)),
                                           ("b", (3, 64, 7))])
def test_interleave_k_matches_reference_and_round_trips(operand, shape):
    x = _int8(0, shape)
    ref = np.asarray(jscheme1.interleave_k(jnp.asarray(x), operand, 32))
    out = scheme1.interleave_k(t(x), operand, 32)
    np.testing.assert_array_equal(out.numpy(), ref)
    back = scheme1.deinterleave_k(out, 3, operand, 32)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jscheme1.deinterleave_k(jnp.asarray(ref), 3,
                                                         operand, 32)))
    with pytest.raises(ValueError):
        scheme1.interleave_k(t(x), "c", 32)


# ---------------------------------------------------------------------------
# K11: the lhs decomposition.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,beta", [(2, 7), (4, 7), (8, 3), (4, 3)])
def test_decompose_lhs_plain_matches_reference(dtype, p, beta):
    x = _conditioned(p + beta, (128, 256), phi=3.0)
    ja = jnp.asarray(x).astype(dtype)
    _, jmu = jscheme1.split(ja, p, beta, axis=1)
    ref = jdecompose.decompose_interleave(ja, jmu, p, beta, bm=128, bk=32)
    ta = t(x).to(getattr(torch, dtype))
    mu = scheme1.pow2_scale(ta, 1)
    np.testing.assert_array_equal(bits(mu), bits(np.asarray(jmu, np.float32)))
    out = decompose.decompose_interleave(ta, mu, p, beta)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decompose_lhs_plain_ragged_pads_with_zero_slices():
    """M = 100, K = 72: the port takes the shape as it is; the reference,
    given the same rows zero-padded to its blocks, writes the same planes."""
    p, beta = 4, 7
    x = _conditioned(5, (100, 72), phi=3.0)
    xp = np.zeros((128, 96), np.float32)
    xp[:100, :72] = x
    _, jmu = jscheme1.split(jnp.asarray(xp), p, beta, axis=1)
    ref = np.asarray(jdecompose.decompose_interleave(jnp.asarray(xp), jmu, p,
                                                     beta, bm=128, bk=32))
    ta = t(x)
    out = decompose.decompose_interleave(ta, scheme1.pow2_scale(ta, 1), p,
                                         beta)
    assert out.shape == (100, p * 96)
    np.testing.assert_array_equal(out.numpy(), ref[:100])


# ---------------------------------------------------------------------------
# K8: EmuGEMM-I on interleaved operands.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [2, 4, 6])
def test_interleaved_plain_matches_reference(out_dtype, p):
    m, k, n = 128, 256, 128
    a, b = _conditioned(p, (m, k)), _conditioned(p + 1, (k, n))
    beta = JCfg(scheme="ozaki1", p=p).resolved_beta(k)
    a_sl, mu = jscheme1.split(jnp.asarray(a), p, beta, axis=1)
    b_sl, nu = jscheme1.split(jnp.asarray(b), p, beta, axis=0)
    a_hat = jscheme1.interleave_k(a_sl, "a", 32)
    b_hat = jscheme1.interleave_k(b_sl, "b", 32)
    jdt = getattr(jnp, out_dtype)
    kern = jozaki1.fused_matmul_interleaved(a_hat, b_hat, mu, nu, p, beta,
                                            JBlocks(128, 128, 32),
                                            out_dtype=jdt)
    oracle = jref.scheme1_interleaved(a_hat, b_hat, mu, nu, p, beta, 32,
                                      out_dtype=jdt)
    out = ozaki1.fused_matmul_interleaved(
        t(np.asarray(a_hat)), t(np.asarray(b_hat)), t(np.asarray(mu)),
        t(np.asarray(nu)), p, beta, getattr(torch, out_dtype))
    assert out.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(bits(out), bits(np.asarray(kern,
                                                             np.float32)))
    np.testing.assert_array_equal(bits(out), bits(np.asarray(oracle,
                                                             np.float32)))


def test_lhs_and_rhs_decompositions_feed_the_interleaved_form():
    """K11(A) and K2r(B) into K8 give K1's bits, on a ragged shape."""
    p, beta = 4, 7
    a, b = t(_conditioned(7, (50, 70))), t(_conditioned(8, (70, 30)))
    mu, nu = scheme1.pow2_scale(a, 1), scheme1.pow2_scale(b, 0)
    out = ozaki1.fused_matmul_interleaved(
        decompose.decompose_interleave(a, mu, p, beta),
        decompose.decompose_interleave_rhs(b, nu, p, beta), mu, nu, p, beta)
    ref = ozaki1.fused_matmul_scheme1(a, b, mu, nu, p, beta, torch.float32)
    assert torch.equal(out, ref)


# ---------------------------------------------------------------------------
# ops.fused_scheme1_matmul: both decomposition routes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [2, 3, 4, 5, 6])
def test_fused_scheme1_matmul_matches_reference(p):
    m, k, n = 128, 256, 128
    a, b = _conditioned(10 + p, (m, k)), _conditioned(20 + p, (k, n))
    outs = {}
    for decomp in ("xla", "kernel"):
        ref = jops.fused_scheme1_matmul(
            jnp.asarray(a), jnp.asarray(b), JCfg(scheme="ozaki1", p=p,
                                                 decomp=decomp))
        out = ops.fused_scheme1_matmul(t(a), t(b), TCfg(scheme="ozaki1", p=p,
                                                        decomp=decomp))
        np.testing.assert_array_equal(bits(out), bits(np.asarray(ref)))
        outs[decomp] = out
    assert torch.equal(outs["xla"], outs["kernel"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_scheme1_routes_agree_on_ragged_shape(dtype):
    a = t(_conditioned(1, (100, 72))).to(dtype)
    b = t(_conditioned(2, (72, 50))).to(dtype)
    out = {d: ops.fused_scheme1_matmul(
        a, b, TCfg(scheme="ozaki1", p=4, decomp=d), out_dtype=dtype)
        for d in ("auto", "kernel", "xla")}
    assert out["xla"].dtype == dtype and out["xla"].shape == (100, 50)
    assert torch.equal(out["xla"], out["kernel"])
    assert torch.equal(out["auto"], out["kernel"])


def test_fused_scheme1_matmul_refuses():
    """What the wrapper refuses; float64 it now runs (as the 2-D front
    door does)."""
    a = torch.randn(8, 16)
    out = ops.fused_scheme1_matmul(a.double(), a.T.double(),
                                   out_dtype=torch.float64)
    assert out.dtype == torch.float64
    assert torch.equal(out, dispatch.emulated_matmul(
        a.double(), a.T.double(), cfg="ozaki1-p4", out_dtype=torch.float64))
    with pytest.raises(ValueError, match="one tile"):
        ops.fused_scheme1_matmul(a, a.T, blocks=JBlocks(128, 128, 128))
    with pytest.raises(ValueError, match="ozaki1-only"):
        ops.fused_scheme1_matmul(a, a.T, "ozaki2-m6")
    out = ops.fused_scheme1_matmul(a, a.T, blocks=KERNEL_BLOCKS)
    assert out.shape == (8, 8) and out.dtype == torch.float32


# ---------------------------------------------------------------------------
# K9: the int8 GEMM.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 512, 128),
                                   (384, 256, 256)])
def test_int8_matmul_plain_matches_reference(m, n, k):
    a8, b8 = _int8(m, (m, k)), _int8(n, (k, n))
    ref = jmatmul_int8.int8_matmul(jnp.asarray(a8), jnp.asarray(b8))
    out = matmul_int8.int8_matmul(t(a8), t(b8))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jref.int8_matmul(jnp.asarray(a8),
                                                 jnp.asarray(b8))))


def test_int8_matmul_ragged_exact_and_refusals():
    a8, b8 = _int8(1, (37, 1000)), _int8(2, (1000, 77))
    out = matmul_int8.int8_matmul(t(a8), t(b8))
    np.testing.assert_array_equal(
        out.numpy(), a8.astype(np.int64) @ b8.astype(np.int64))
    with pytest.raises(ValueError, match="blocks"):
        matmul_int8.int8_matmul(t(a8), t(b8), JBlocks(128, 128, 128))
    with pytest.raises(ValueError, match="int8"):
        matmul_int8.int8_matmul(t(a8).float(), t(b8))


# ---------------------------------------------------------------------------
# The package surface.
# ---------------------------------------------------------------------------

def test_package_surface_matches_reference():
    assert repro_torch.__all__ == repro.__all__
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None, name
    from repro_torch import guard as tguard, telemetry as ttele
    from repro_torch.core.emulated import emulated_dot
    from repro_torch.kernels.prepared import PreparedOperand
    assert repro_torch.emulated_dot is emulated_dot
    assert repro_torch.PreparedOperand is PreparedOperand
    assert repro_torch.emulated_matmul is dispatch.emulated_matmul
    assert repro_torch.guard is tguard and repro_torch.telemetry is ttele
    assert repro_torch.verify_gemm is tguard.verify_gemm
    assert tguard.__all__ == repro.guard.__all__
    assert ttele.__all__ == repro.telemetry.__all__
    with pytest.raises(AttributeError):
        repro_torch.no_such_name  # noqa: B018
    a = t(_conditioned(3, (16, 32)))
    b = t(_conditioned(4, (32, 8)))
    np.testing.assert_array_equal(
        bits(repro_torch.einsum("ik,kj->ij", a, b, precision="ozaki1-p4")),
        bits(dispatch.emulated_matmul(a, b, cfg="ozaki1-p4")))


def test_kernels_reexports_resolve_lazily():
    reexports = {"KernelBackend", "available_backends", "get_backend",
                 "resolve_backend", "auto_fused_matmul", "emulated_matmul",
                 "emulated_matmul_batched", "plan_emulated", "resolve_policy",
                 "select_blocks", "PreparedOperand", "prepare_params",
                 "prepare_rhs"}
    assert reexports <= set(dir(tkernels))
    assert tkernels.auto_fused_matmul is dispatch.auto_fused_matmul
    assert tkernels.available_backends() == ("cuda", "torch")
    with pytest.raises(AttributeError):
        tkernels.build_pallas_call  # noqa: B018
    assert ops.int8_matmul is matmul_int8.int8_matmul


def test_maybe_fused_matmul_warns_and_dispatches():
    a = t(_conditioned(5, (16, 32)))
    b = t(_conditioned(6, (32, 8)))
    cfg = TCfg(scheme="ozaki1", p=3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = ops.maybe_fused_matmul(a, b, cfg)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert torch.equal(out, dispatch.auto_fused_matmul(a, b, cfg))
