"""Complex emulated GEMMs in the port against the JAX reference, bit for
bit: Scheme II by 3M (repro_torch.core.complex3m, the plain versions of
the 3M kernels K7g and K7 in kernels/ozaki3m.py, ops.fused_3m_matmul) and
Scheme I by 4M (scheme1.matmul_complex_4m), through the dispatcher and
the front doors.

The same seeded numpy inputs (paper Eq. 19 matrices, real and imaginary
parts drawn alike) go through both packages. complex64 is compared with
the reference as it runs by default; complex128 inside
``jax.enable_x64(True)`` (the context manager only: tests share worker
processes), where the reference reconstructs in float64 as the port does
for float64 parts (ROADMAP.md § 3 H6). The reference's kernels run as its
own tests run them on the CPU: K7 in interpret mode, K7g through the
'gpu' backend. The CUDA kernels are held to these plain versions on the
card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from conftest import conditioned
from repro import api as japi
from repro.core import complex3m as jc3, scheme1 as jscheme1
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import dispatch as jdispatch, ops as jops
from repro.kernels import ozaki3m as jozaki3m, ref as jref
from repro_torch import api as tapi
from repro_torch.core import complex3m, scheme1
from repro_torch.core.precision import EmulationConfig, default_moduli
from repro_torch.kernels import dispatch, ops, ozaki1, ozaki3m

MODULI_COUNTS = [4, 8, 12, 16]
CTYPES = {"complex64": np.complex64, "complex128": np.complex128}


def _cplx(rng, shape, dtype="complex64"):
    x = (conditioned(rng, shape, dtype=np.float64)
         + 1j * conditioned(rng, shape, dtype=np.float64))
    return x.astype(CTYPES[dtype])


def _bits(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag])
    return x.view(f"i{x.dtype.itemsize}") if x.dtype.kind == "f" else x


def _same(x: torch.Tensor, y) -> None:
    """Bitwise equality of a torch tensor and a jax array, parts and type
    included."""
    x, y = x.detach().numpy(), np.asarray(y)
    assert x.dtype == y.dtype, (x.dtype, y.dtype)
    np.testing.assert_array_equal(_bits(x), _bits(y))


def _x64(dtype: str):
    """The reference's mode for this type: x64 for complex128."""
    return jax.enable_x64(dtype == "complex128")


def _cfg(p, scheme="ozaki2"):
    return (JCfg(scheme=scheme, p=p), EmulationConfig(scheme=scheme, p=p))


# ---------------------------------------------------------------------------
# complex3m.matmul, the torch backend's 3M.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mkn", [(32, 64, 48), (37, 50, 29)])
@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_complex64_matmul_bit_identical(p, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(100 * p + m)
    a, b = _cplx(rng, (m, k)), _cplx(rng, (k, n))
    jcfg, cfg = _cfg(p)
    out = complex3m.matmul(t(a), t(b), cfg)
    assert out.dtype == torch.complex64
    _same(out, jc3.matmul(jnp.asarray(a), jnp.asarray(b), jcfg))


@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_complex128_matmul_bit_identical_under_x64(p):
    rng = np.random.default_rng(p)
    a, b = _cplx(rng, (37, 50), "complex128"), _cplx(rng, (50, 29),
                                                      "complex128")
    jcfg, cfg = _cfg(p)
    with jax.enable_x64(True):
        ref = jc3.matmul(jnp.asarray(a), jnp.asarray(b), jcfg)
    out = complex3m.matmul(t(a), t(b), cfg)
    assert out.dtype == torch.complex128
    _same(out, ref)
    if p == 16:                       # ZGEMM grade
        exact = a.astype(np.clongdouble) @ b.astype(np.clongdouble)
        rel = np.abs(out.numpy() - exact).max() / np.abs(exact).max()
        assert rel < 2.0 ** -46, rel


@pytest.mark.parametrize("dtype", list(CTYPES))
@pytest.mark.parametrize("side", ["complex @ real", "real @ complex"])
def test_mixed_complex_and_real_operands(side, dtype):
    """A real operand is its own real part with a zero imaginary part."""
    rng = np.random.default_rng(len(side) + len(dtype))
    a, b = _cplx(rng, (24, 40), dtype), _cplx(rng, (40, 16), dtype)
    if side == "complex @ real":
        b = b.real.copy()
    else:
        a = a.real.copy()
    jcfg, cfg = _cfg(8)
    with _x64(dtype):
        ref = jc3.matmul(jnp.asarray(a), jnp.asarray(b), jcfg,
                         out_dtype=a.real.dtype)
    _same(complex3m.matmul(t(a), t(b), cfg, out_dtype=t(a).real.dtype), ref)


@pytest.mark.parametrize("dtype", list(CTYPES))
def test_rows_of_tiny_magnitude_under_daz(dtype):
    """Rows whose mu * nu is huge, so that inv = 1 / (mu * nu) is
    subnormal or zero; compared under flush-to-zero, as XLA:CPU runs
    (ROADMAP.md § 3 H1)."""
    rng = np.random.default_rng(9)
    a, b = _cplx(rng, (16, 32), dtype), _cplx(rng, (32, 12), dtype)
    tiny = 2.0 ** -120 if dtype == "complex64" else 2.0 ** -1000
    a[2] *= tiny
    a[5, ::3] *= tiny
    b[:, 4] *= tiny
    jcfg, cfg = _cfg(12)
    with _x64(dtype):
        ref = jc3.matmul(jnp.asarray(a), jnp.asarray(b), jcfg)
    assert torch.set_flush_denormal(True)
    try:
        out = complex3m.matmul(t(a), t(b), cfg)
    finally:
        torch.set_flush_denormal(False)
    _same(out, ref)


def test_gemm_count_and_budget():
    jcfg, cfg = _cfg(8)
    assert complex3m.gemm_count(cfg) == jc3.gemm_count(jcfg) == 24
    with pytest.raises(ValueError, match="exceed 256"):
        complex3m.matmul(torch.ones(2, 4, dtype=torch.complex64),
                         torch.ones(4, 2, dtype=torch.complex64),
                         EmulationConfig(scheme="ozaki2", p=1,
                                         moduli=(257,)))


# ---------------------------------------------------------------------------
# The plain versions of the 3M kernels against the reference's kernels.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [4, 8])
def test_residue_3m_plain_matches_reference_kernel(p):
    """K7: the plain version against ozaki3m.fused_3m_residue_matmul in
    interpret mode, and against the reference's oracle on a ragged
    shape (where the wrapper takes the plain version on CPU tensors)."""
    moduli = default_moduli(p)
    rng = np.random.default_rng(p)
    a3 = rng.integers(-128, 128, (p, 3, 128, 128)).astype(np.int8)
    b3 = rng.integers(-128, 128, (p, 3, 128, 128)).astype(np.int8)
    ref = jozaki3m.fused_3m_residue_matmul(jnp.asarray(a3), jnp.asarray(b3),
                                           moduli)
    out = ozaki3m.fused_3m_residue_matmul_plain(t(a3), t(b3), moduli)
    for x, y in zip(out, ref):
        _same(x, y)
    a2, b2 = a3[:, :, :37, :100], b3[:, :, :100, :29]
    for x, y in zip(ozaki3m.fused_3m_residue_matmul(t(a2), t(b2), moduli),
                    jref.scheme2_3m(jnp.asarray(a2), jnp.asarray(b2),
                                    moduli)):
        _same(x, y)


@pytest.mark.parametrize("dtype,p,side", [("complex64", 4, "complex"),
                                          ("complex128", 8, "complex"),
                                          ("complex64", 6, "complex @ real")])
def test_fused_3m_plain_matches_reference_gpu_kernel(dtype, p, side):
    """K7g: the 'cuda' backend (its wrapper runs the plain version on CPU
    tensors) against the reference's fused 3M GPU lowering in interpret
    mode, ragged."""
    rng = np.random.default_rng(p)
    a, b = _cplx(rng, (40, 72), dtype), _cplx(rng, (72, 24), dtype)
    if side == "complex @ real":
        b = b.real.copy()
    with _x64(dtype):
        ref = jdispatch.emulated_matmul(
            jnp.asarray(a), jnp.asarray(b),
            cfg=JCfg(scheme="ozaki2", p=p, backend="gpu"))
    before = ozaki3m.COUNTS.plain_cuda_calls
    out = dispatch.emulated_matmul(t(a), t(b), cfg=f"ozaki2-m{p}",
                                   backend="cuda")
    assert ozaki3m.COUNTS.plain_cuda_calls == before
    _same(out, ref)
    # The torch backend's complex3m.matmul is the same function.
    assert torch.equal(out, dispatch.emulated_matmul(
        t(a), t(b), cfg=f"ozaki2-m{p}", backend="torch"))


@pytest.mark.parametrize("dtype", list(CTYPES))
def test_ops_fused_3m_matches_reference_and_the_fused_kernel(dtype):
    rng = np.random.default_rng(11)
    a, b = _cplx(rng, (128, 128), dtype), _cplx(rng, (128, 128), dtype)
    jcfg, cfg = _cfg(6)
    with _x64(dtype):
        ref = jops.fused_3m_matmul(jnp.asarray(a), jnp.asarray(b), jcfg)
    out = ops.fused_3m_matmul(t(a), t(b), cfg)
    _same(out, ref)
    assert torch.equal(out, dispatch.emulated_matmul(t(a), t(b), cfg=cfg,
                                                     backend="cuda"))
    with pytest.raises(ValueError, match="ozaki2-only"):
        ops.fused_3m_matmul(t(a), t(b), "ozaki1-p4")


# ---------------------------------------------------------------------------
# Scheme I complex: 4M.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", ["complex", "complex @ real"])
def test_complex64_4m_bit_identical(side):
    rng = np.random.default_rng(4)
    a, b = _cplx(rng, (30, 64)), _cplx(rng, (64, 20))
    if side == "complex @ real":
        b = b.real.copy()
    jcfg, cfg = _cfg(4, "ozaki1")
    ref = jscheme1.matmul_complex_4m(jnp.asarray(a), jnp.asarray(b), jcfg)
    out = scheme1.matmul_complex_4m(t(a), t(b), cfg)
    _same(out, ref)
    # Both backends of the dispatcher run it; the 'cuda' one as four
    # launches of EmuGEMM-I's wrapper (its plain version on CPU tensors).
    before = ozaki1.COUNTS.plain_cuda_calls
    for backend in ("cuda", "torch"):
        assert torch.equal(dispatch.emulated_matmul(
            t(a), t(b), cfg="ozaki1-p4", backend=backend), out)
    assert ozaki1.COUNTS.plain_cuda_calls == before


def test_complex128_under_scheme1_raises():
    """complex128 under Scheme I no longer raises: both backends run 4M of
    float64 parts, with the same bits (the reference comparison is in
    tests/test_torch_scheme1_wide.py)."""
    a = torch.complex(torch.linspace(-1, 1, 32, dtype=torch.float64),
                      torch.linspace(2, -3, 32, dtype=torch.float64))
    a = a.reshape(4, 8)
    outs = [dispatch.emulated_matmul(a, a.T, cfg="ozaki1-p4", backend=backend)
            for backend in ("cuda", "torch")]
    assert outs[0].dtype == torch.complex128
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], a @ a.T, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The front doors.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,dtype", [("ozaki2-m8", "complex64"),
                                        ("ozaki2-m12", "complex128"),
                                        ("ozaki1-p4", "complex64")])
def test_einsum_and_dot_general_on_complex_operands(spec, dtype):
    """2-D and batched contractions (the batched one runs one 2-D GEMM
    per batch element, as the reference's vmap does). The reference runs
    on its 'xla' backend, whose results its tests hold equal to its
    kernels', because its default here, K7 in interpret mode, takes
    seconds a call."""
    rng = np.random.default_rng(len(spec))
    a, b = _cplx(rng, (2, 20, 36), dtype), _cplx(rng, (2, 36, 12), dtype)
    with _x64(dtype):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ref2 = japi.einsum("mk,kn->mn", ja[0], jb[0], precision=spec,
                           backend="xla")
        refb = japi.einsum("bmk,bkn->bmn", ja, jb, precision=spec,
                           backend="xla")
        refd = japi.dot_general(ja[1], jb[1], (((1,), (0,)), ((), ())),
                                precision=spec, backend="xla")
    _same(tapi.einsum("mk,kn->mn", t(a[0]), t(b[0]), precision=spec), ref2)
    _same(tapi.einsum("bmk,bkn->bmn", t(a), t(b), precision=spec), refb)
    _same(tapi.dot_general(t(a[1]), t(b[1]), (((1,), (0,)), ((), ())),
                           precision=spec), refd)


def test_complex_autograd_raises():
    """A differentiated complex product no longer raises: its gradient is
    PyTorch's conjugate one (held against the reference's VJP in
    tests/test_torch_scheme1_wide.py); without grad it runs forward."""
    a = torch.ones(4, 8, dtype=torch.complex64, requires_grad=True)
    b = torch.ones(8, 3, dtype=torch.complex64)
    out = tapi.einsum("mk,kn->mn", a, b, precision="ozaki2-m8")
    out.backward(torch.full((4, 3), 1 + 1j, dtype=torch.complex64))
    torch.testing.assert_close(a.grad, torch.full((4, 8), 3 + 3j,
                                                  dtype=torch.complex64))
    with torch.no_grad():
        out = tapi.einsum("mk,kn->mn", a, b, precision="ozaki2-m8")
    assert out.dtype == torch.complex64 and out.shape == (4, 3)
