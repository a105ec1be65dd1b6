"""The plane route of DGEMM- and ZGEMM-grade Scheme II (the encode and
plane-GEMM kernels of csrc/emugemm2_planes.cu) through their plain
versions, against the JAX reference, bit for bit.

The encode writes each operand's balanced residues once, as K-contiguous
int8 planes padded with zero residues to the plane GEMM's K tile: (p, R,
Kp) for a float64 operand (``ozaki2.encode_planes_plain``), (p, 3, R, Kp)
phases [re, im, bal(re + im)] for a 3M operand
(``ozaki3m.encode_planes_3m_plain``); B enters as B^T. Those layouts are
held against the reference's ``scheme2.integerize`` and
``balanced_residues`` (and ``complex3m._balanced`` for the sum phase),
and the planes, multiplied per modulus, reduced (3M: combined) and
reconstructed by the plane GEMM's plain version, against the reference's
fused GPU lowerings (``gpu.fused_matmul_scheme2``, ``gpu.fused_matmul_3m``)
in interpret mode; with a leading batch axis (planes (p, Bt, R, Kp)),
against ``gpu.fused_matmul_scheme2_batched`` and ``gpu.fused_matmul_3m``
per element. float64 and complex128 are compared inside
``jax.enable_x64(True)``, the context manager only (tests share worker
processes). The kernels themselves are held to these plain versions on
the card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from conftest import conditioned
from repro.core import complex3m as jc3, scheme2 as jscheme2
from repro.kernels.backends import gpu as jgpu
from repro.kernels.common import Blocks as JBlocks
from repro_torch.core import complex3m, scheme2
from repro_torch.core.precision import default_moduli
from repro_torch.kernels import ozaki2, ozaki3m

F64 = torch.float64
MODULI_COUNTS = [4, 8, 16]
# (M, K, N): ragged, and K <= 8.
SHAPES = {"ragged": (37, 70, 29), "K<=8": (9, 5, 11)}


def _same(x: torch.Tensor, y) -> None:
    """Bitwise equality of a tensor and a jax or numpy array, type
    included (complex: both parts)."""
    x, y = x.detach().numpy(), np.asarray(y)
    assert x.dtype == y.dtype, (x.dtype, y.dtype)
    if np.iscomplexobj(x):
        x, y = np.stack([x.real, x.imag]), np.stack([y.real, y.imag])
    if x.dtype.kind == "f":
        x, y = x.view(f"i{x.itemsize}"), y.view(f"i{y.itemsize}")
    np.testing.assert_array_equal(x, y)


def _planes(res, k):
    """(..., R, K) reference residues as the encode lays them out: padded
    with zero residues to the plane GEMM's K tile."""
    res = np.asarray(res)
    pad = [(0, 0)] * (res.ndim - 1) + [(0, ozaki2.plane_k(k) - k)]
    return np.pad(res, pad)


def _f64(rng, shape):
    return conditioned(rng, shape, dtype=np.float64)


def _cplx(rng, shape, dtype=np.complex128):
    return (_f64(rng, shape) + 1j * _f64(rng, shape)).astype(dtype)


@pytest.mark.parametrize("case", ["ragged", "B transposed", "K<=8"])
@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_encode_planes_plain_matches_reference(p, case):
    """float64: the planes of A (rows scaled by mu) and of B^T (B's
    columns scaled by nu, read through the transposed view)."""
    m, k, n = SHAPES["K<=8" if case == "K<=8" else "ragged"]
    moduli = default_moduli(p)
    rng = np.random.default_rng(p)
    x = _f64(rng, (m, k)) if case != "B transposed" else _f64(rng, (k, n))
    axis = 0 if case == "B transposed" else 1
    with jax.enable_x64(True):
        ref_int, ref_s = jscheme2.integerize(jnp.asarray(x), axis, 52)
        ref = jscheme2.balanced_residues(ref_int, moduli)
        if axis == 0:
            ref, ref_s = jnp.swapaxes(ref, 1, 2), ref_s.T
    tx, ts = t(x), t(np.asarray(ref_s))
    if axis == 0:
        tx = tx.T
    before = ozaki2.COUNTS.plain_cuda_calls
    planes = ozaki2.encode_planes(tx, ts, moduli)
    assert ozaki2.COUNTS.plain_cuda_calls == before
    assert planes.shape == (p, tx.shape[0], 128) and planes.dtype == torch.int8
    _same(planes, _planes(ref, tx.shape[1]))


@pytest.mark.parametrize("case", ["complex128", "complex64", "B^T",
                                  "real operand", "K<=8"])
@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_encode_planes_3m_plain_matches_reference(p, case):
    """The 3M phases [re, im, bal(re + im)] of an operand with one scale
    per row shared by its parts: complex128 (and complex64, without x64),
    B^T of a complex B, a real operand (a zero imaginary phase), K <= 8."""
    m, k, n = SHAPES["K<=8" if case == "K<=8" else "ragged"]
    moduli = default_moduli(p)
    rng = np.random.default_rng(10 + p)
    dtype = np.complex64 if case == "complex64" else np.complex128
    x = _cplx(rng, (k, n) if case == "B^T" else (m, k), dtype)
    if case == "B^T":
        x = np.ascontiguousarray(x.T)
    if case == "real operand":
        x = x.real.copy()
    tx = t(x) if case != "B^T" else t(np.ascontiguousarray(x.T)).T
    scale = complex3m.scales(tx, tx.T, moduli)[0]
    with jax.enable_x64(case != "complex64"):
        jx, js = jnp.asarray(x), jnp.asarray(scale.numpy())
        re = jscheme2.balanced_residues(jnp.trunc(jnp.real(jx) * js), moduli)
        im = jscheme2.balanced_residues(jnp.trunc(jnp.imag(jx) * js), moduli)
        sums = jnp.stack([jc3._balanced(re[l].astype(jnp.int32)
                                        + im[l].astype(jnp.int32), mm)
                          for l, mm in enumerate(moduli)])
        ref = jnp.stack([re, im, sums], axis=1)
    before = ozaki3m.COUNTS.plain_cuda_calls
    planes = ozaki3m.encode_planes_3m(tx, scale, moduli)
    assert ozaki3m.COUNTS.plain_cuda_calls == before
    assert planes.shape == (p, 3, tx.shape[0], 128)
    _same(planes, _planes(ref, tx.shape[1]))


@pytest.mark.parametrize("out", ["float64", "float32"])
@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_plane_route_matches_reference_gpu_kernel(p, out):
    """Planes of A and B^T -> per-modulus int32 products -> floor mod ->
    CRT -> / (mu * nu), the plane GEMM's plain version, equals the
    reference's fused GPU kernel in interpret mode, and the DGEMM front
    door's plain version."""
    m, k, n = 48, 40, 32
    moduli = default_moduli(p)
    rng = np.random.default_rng(20 + p)
    a, b = _f64(rng, (m, k)), _f64(rng, (k, n))
    ta, tb = t(a), t(b)
    mu, nu = scheme2.scales(ta, tb, moduli)
    out_t, out_j = ((F64, jnp.float64) if out == "float64"
                    else (torch.float32, jnp.float32))
    with jax.enable_x64(True):
        ref = jgpu.fused_matmul_scheme2(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(mu.numpy()),
            jnp.asarray(nu.numpy()), moduli, JBlocks(m, n, k),
            out_dtype=out_j)
    got = ozaki2.plane_matmul(ozaki2.encode_planes(ta, mu, moduli),
                              ozaki2.encode_planes(tb.T, nu.T, moduli),
                              mu, nu, moduli, out_t)
    _same(got, ref)
    assert torch.equal(got, ozaki2.fused_matmul_scheme2(ta, tb, mu, nu,
                                                        moduli, out_t))


@pytest.mark.parametrize("case", ["complex @ complex", "complex @ real",
                                  "real @ complex"])
@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_plane_route_3m_matches_reference_gpu_kernel(p, case):
    """Phase planes of A and B^T -> the three products per modulus, each
    reduced, combined into C_re and C_im mod m -> two CRTs -> * 1 / (mu *
    nu) equals the reference's fused 3M GPU kernel in interpret mode
    (complex128 under x64), and the ZGEMM front door's plain version."""
    m, k, n = 32, 24, 16
    moduli = default_moduli(p)
    rng = np.random.default_rng(30 + p)
    a, b = _cplx(rng, (m, k)), _cplx(rng, (k, n))
    if case == "complex @ real":
        b = b.real.copy()
    if case == "real @ complex":
        a = a.real.copy()
    ta, tb = t(a), t(b)
    mu, nu = complex3m.scales(ta, tb, moduli)
    with jax.enable_x64(True):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        c_re, c_im = jgpu.fused_matmul_3m(
            jnp.real(ja), jnp.imag(ja), jnp.real(jb), jnp.imag(jb),
            jnp.asarray(mu.numpy()), jnp.asarray(nu.numpy()), moduli,
            JBlocks(m, n, k), out_dtype=jnp.float64)
        ref = np.asarray(jax.lax.complex(c_re, c_im))
    got = ozaki3m.plane_matmul_3m(ozaki3m.encode_planes_3m(ta, mu, moduli),
                                  ozaki3m.encode_planes_3m(tb.T, nu.T,
                                                           moduli),
                                  mu, nu, moduli, F64)
    _same(got, ref)
    assert torch.equal(got, ozaki3m.fused_matmul_3m(ta, tb, mu, nu, moduli,
                                                    F64))


def test_plane_wrappers_count_no_launch_on_cpu():
    """On CPU tensors every wrapper of the plane route takes its plain
    version: the encode and plane-GEMM counts stay 0, and no plain call is
    counted as one made on CUDA."""
    moduli = default_moduli(8)
    rng = np.random.default_rng(40)
    a, b = t(_f64(rng, (20, 30))), t(_f64(rng, (30, 10)))
    za, zb = t(_cplx(rng, (20, 30))), t(_cplx(rng, (30, 10)))
    ozaki2.COUNTS.reset()
    ozaki3m.COUNTS.reset()
    mu, nu = scheme2.scales(a, b, moduli)
    out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, F64)
    assert torch.equal(out, ozaki2.plane_matmul(
        ozaki2.encode_planes(a, mu, moduli),
        ozaki2.encode_planes(b.T, nu.T, moduli), mu, nu, moduli, F64))
    zmu, znu = complex3m.scales(za, zb, moduli)
    zout = ozaki3m.fused_matmul_3m(za, zb, zmu, znu, moduli, F64)
    assert torch.equal(zout, ozaki3m.plane_matmul_3m(
        ozaki3m.encode_planes_3m(za, zmu, moduli),
        ozaki3m.encode_planes_3m(zb.T, znu.T, moduli), zmu, znu, moduli,
        F64))
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes,
            ozaki2.COUNTS.launches_2d, ozaki2.COUNTS.plain_cuda_calls) == (
                0, 0, 0, 0)
    assert (ozaki3m.COUNTS.launches_encode, ozaki3m.COUNTS.launches_planes,
            ozaki3m.COUNTS.plain_cuda_calls) == (0, 0, 0)


# The batch coordinate of the plane route (Bt, M, K, N): ragged M, N and K
# in every element, so that a row leaking from one element into the next
# would show.
BATCHED = (3, 37, 70, 29)


@pytest.mark.parametrize("case", ["ragged", "B transposed", "Bt = 1"])
@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_batched_plane_route_matches_reference_gpu_kernel(p, case):
    """Batched planes of A and B^T -> the plane GEMM's plain version
    equals the reference's batched fused GPU kernel
    (``gpu.fused_matmul_scheme2_batched``) in interpret mode, element by
    element; the planes of each element are those of its 2-D encode; at
    Bt = 1 the batched route equals the 2-D route."""
    bt, m, k, n = (1,) + BATCHED[1:] if case == "Bt = 1" else BATCHED
    moduli = default_moduli(p)
    rng = np.random.default_rng(50 + p)
    a = _f64(rng, (bt, m, k))
    b = (np.ascontiguousarray(np.swapaxes(_f64(rng, (bt, n, k)), 1, 2))
         if case == "B transposed" else _f64(rng, (bt, k, n)))
    ta = t(a)
    tb = (t(np.ascontiguousarray(np.swapaxes(b, 1, 2))).transpose(1, 2)
          if case == "B transposed" else t(b))
    mu, nu = scheme2.scales(ta, tb, moduli)
    with jax.enable_x64(True):
        ref = jgpu.fused_matmul_scheme2_batched(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(mu.numpy()),
            jnp.asarray(nu.numpy()), moduli, JBlocks(m, n, k),
            out_dtype=jnp.float64)
    a_planes = ozaki2.encode_planes(ta, mu, moduli)
    b_planes = ozaki2.encode_planes(tb.transpose(1, 2), nu.transpose(1, 2),
                                    moduli)
    assert a_planes.shape == (p, bt, m, 128)
    assert b_planes.shape == (p, bt, n, 128)
    for e in range(bt):
        assert torch.equal(a_planes[:, e],
                           ozaki2.encode_planes(ta[e], mu[e], moduli))
        assert torch.equal(b_planes[:, e], ozaki2.encode_planes(
            tb[e].T, nu[e].T, moduli))
    got = ozaki2.plane_matmul(a_planes, b_planes, mu, nu, moduli, F64)
    _same(got, ref)
    assert torch.equal(got, ozaki2.fused_matmul_scheme2(ta, tb, mu, nu,
                                                        moduli, F64))
    if case == "Bt = 1":
        assert torch.equal(got[0], ozaki2.fused_matmul_scheme2(
            ta[0], tb[0], mu[0], nu[0], moduli, F64))


@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_batched_plane_route_3m_matches_reference_per_element(p):
    """Batched 3M phase planes -> the 3M plane GEMM's plain version equals
    the reference's fused 3M GPU kernel run on each element (what the
    reference's vmap computes), complex128 under x64; the batch through
    the dispatcher under ozaki2 is the same route."""
    from repro_torch.kernels import dispatch
    bt, m, k, n = BATCHED
    moduli = default_moduli(p)
    rng = np.random.default_rng(60 + p)
    a, b = _cplx(rng, (bt, m, k)), _cplx(rng, (bt, k, n))
    ta, tb = t(a), t(b)
    mu, nu = complex3m.scales(ta, tb, moduli)
    with jax.enable_x64(True):
        refs = []
        for e in range(bt):
            ja, jb = jnp.asarray(a[e]), jnp.asarray(b[e])
            c_re, c_im = jgpu.fused_matmul_3m(
                jnp.real(ja), jnp.imag(ja), jnp.real(jb), jnp.imag(jb),
                jnp.asarray(mu[e].numpy()), jnp.asarray(nu[e].numpy()),
                moduli, JBlocks(m, n, k), out_dtype=jnp.float64)
            refs.append(np.asarray(jax.lax.complex(c_re, c_im)))
    a3 = ozaki3m.encode_planes_3m(ta, mu, moduli)
    b3 = ozaki3m.encode_planes_3m(tb.transpose(1, 2), nu.transpose(1, 2),
                                  moduli)
    assert a3.shape == (p, 3, bt, m, 128) and b3.shape == (p, 3, bt, n, 128)
    got = ozaki3m.plane_matmul_3m(a3, b3, mu, nu, moduli, F64)
    _same(got, np.stack(refs))
    assert torch.equal(got, ozaki3m.fused_matmul_3m(ta, tb, mu, nu, moduli,
                                                    F64))
    assert torch.equal(got, dispatch.emulated_matmul_batched(
        ta, tb, cfg=f"ozaki2-m{p}"))


def test_batched_plane_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the batched wrappers of the plane route take their
    plain versions: no launch is counted, and no plain call as one made on
    CUDA."""
    moduli = default_moduli(8)
    rng = np.random.default_rng(70)
    a, b = t(_f64(rng, (2, 20, 30))), t(_f64(rng, (2, 30, 10)))
    za, zb = t(_cplx(rng, (2, 20, 30))), t(_cplx(rng, (2, 30, 10)))
    ozaki2.COUNTS.reset()
    ozaki3m.COUNTS.reset()
    mu, nu = scheme2.scales(a, b, moduli)
    out = ozaki2.fused_matmul_scheme2(a, b, mu, nu, moduli, F64)
    assert out.shape == (2, 20, 10)
    assert torch.equal(out, ozaki2.plane_matmul(
        ozaki2.encode_planes(a, mu, moduli),
        ozaki2.encode_planes(b.transpose(1, 2), nu.transpose(1, 2), moduli),
        mu, nu, moduli, F64))
    zmu, znu = complex3m.scales(za, zb, moduli)
    zout = ozaki3m.fused_matmul_3m(za, zb, zmu, znu, moduli, F64)
    assert zout.shape == (2, 20, 10) and zout.dtype == torch.complex128
    assert (ozaki2.COUNTS.launches_encode, ozaki2.COUNTS.launches_planes,
            ozaki2.COUNTS.launches_batched, ozaki2.COUNTS.plain_cuda_calls
            ) == (0, 0, 0, 0)
    assert (ozaki3m.COUNTS.launches_encode, ozaki3m.COUNTS.launches_planes,
            ozaki3m.COUNTS.plain_cuda_calls) == (0, 0, 0)
