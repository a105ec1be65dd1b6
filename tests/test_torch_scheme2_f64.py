"""DGEMM-grade Scheme II in the port (float64 operands and outputs of
repro_torch.core.{dd,scheme2}, kernels/ozaki2.py, kernels/ops.py and the
dispatcher) against the JAX reference under x64, bit for bit.

The reference picks its residue integer and double-double types from the
global x64 flag; the port from the operands and the output (ROADMAP.md
§ 3 H6): int64 residues for float64 operands, a float64 double-double
for a float64 output. So float64 problems, and float32 operands with a
float64 output, are held against the reference inside
``jax.enable_x64(True)``, the context manager only: tests share worker
processes (``--dist loadfile``), and the global config flag would change
the types of every later JAX test in the worker. Inputs are paper Eq. 19
matrices drawn in float64 from seeded numpy. Subnormal inputs are
compared under flush-to-zero, as XLA:CPU computes (H1). The EmuGEMM-II
kernel itself is held to these plain versions on the card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from conftest import conditioned
from repro.core import dd as jdd, scheme2 as jscheme2
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import dispatch as jdispatch, ops as jops
from repro_torch.core import dd, scheme2
from repro_torch.core.precision import EmulationConfig, default_moduli
from repro_torch.kernels import dispatch, ops, ozaki2

F64 = torch.float64
DGEMM_MODULI = [9, 12, 15, 16]


def _same(x: torch.Tensor, y) -> None:
    """Bitwise equality of a float64 tensor and a jax array (ints as
    values)."""
    y = np.asarray(y)
    x = x.detach().numpy()
    assert x.dtype == y.dtype, (x.dtype, y.dtype)
    if x.dtype.kind == "f":
        x, y = x.view(f"i{x.itemsize}"), y.view(f"i{y.itemsize}")
    np.testing.assert_array_equal(x, y)


def _f64(rng, shape, phi=2.0):
    return conditioned(rng, shape, phi, dtype=np.float64)


def test_dd_float64_bit_identical():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096) * np.exp2(rng.integers(-300, 300, 4096))
    b = rng.standard_normal(4096) * np.exp2(rng.integers(-300, 300, 4096))
    big = np.where(np.abs(a) >= np.abs(b), a, b)
    small = np.where(np.abs(a) >= np.abs(b), b, a)
    digits = rng.integers(-128, 129, 4096).astype(np.float64)
    with jax.enable_x64(True):
        assert dd._split_constant(F64) == jdd._split_constant(
            jnp.float64) == 2.0 ** 27 + 1
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        for got, want in (
                (dd.two_sum(t(a), t(b)), jdd.two_sum(ja, jb)),
                (dd.quick_two_sum(t(big), t(small)),
                 jdd.quick_two_sum(jnp.asarray(big), jnp.asarray(small))),
                (dd.two_prod(t(a), t(b)), jdd.two_prod(ja, jb)),
                (dd.mul_scalar(t(big), t(small), 251.0),
                 jdd.mul_scalar(jnp.asarray(big), jnp.asarray(small), 251.0)),
                (dd.add_scalar_array(t(big), t(small), t(digits)),
                 jdd.add_scalar_array(jnp.asarray(big), jnp.asarray(small),
                                      jnp.asarray(digits)))):
            for x, y in zip(got, want):
                assert x.dtype == F64
                _same(x, y)


def test_integerize_and_int64_residues_bit_identical():
    """float64 scales clamp at 2^1023, integers run to 2^52 and their
    residues go through int64 (the int32 of float32 would wrap)."""
    rng = np.random.default_rng(1)
    a = _f64(rng, (10, 40), phi=6.0)
    a[1] = 0.0
    a[3] *= 1e-300
    a[5] *= 1e250
    moduli = default_moduli(16)
    with jax.enable_x64(True):
        for axis in (1, 0):
            ref_int, ref_mu = jscheme2.integerize(jnp.asarray(a), axis, 52)
            got_int, got_mu = scheme2.integerize(t(a), axis, 52)
            _same(got_mu, ref_mu)
            _same(got_int, ref_int)
            assert np.abs(np.asarray(ref_int)).max() >= 2.0 ** 51
            _same(scheme2.balanced_residues(got_int, moduli),
                  jscheme2.balanced_residues(ref_int, moduli))


@pytest.mark.parametrize("p", [9, 16])
def test_float64_crt_bit_identical(p):
    moduli = default_moduli(p)
    rng = np.random.default_rng(p)
    big = min(int(np.prod([float(m) for m in moduli]) // 4), 2 ** 62)
    x = rng.integers(-big, big, (9, 17), dtype=np.int64)
    x[0, :4] = [0, 1, -1, big - 1]
    res = np.stack([np.mod(x, m) for m in moduli]).astype(np.int32)
    with jax.enable_x64(True):
        digits = scheme2.garner_digits(t(res), moduli)
        jdigits = jscheme2.garner_digits(jnp.asarray(res), moduli)
        hi, lo = scheme2.mixed_radix_to_dd(digits, moduli, F64)
        jhi, jlo = jscheme2.mixed_radix_to_dd(jdigits, moduli)
        _same(hi, jhi)
        _same(lo, jlo)
        c = scheme2.crt_reconstruct(t(res), moduli, F64)
        _same(c, jscheme2.crt_reconstruct(jnp.asarray(res), moduli,
                                          jnp.float64))
    # Exact for the values a float64 holds exactly.
    np.testing.assert_array_equal(c.numpy()[1:, :], x[1:, :].astype(np.float64))


@pytest.mark.parametrize("mkn", [(32, 64, 48), (37, 100, 29)])
@pytest.mark.parametrize("p", DGEMM_MODULI)
def test_matmul_float64_bit_identical_to_reference(p, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(10 * p + m)
    a, b = _f64(rng, (m, k)), _f64(rng, (k, n))
    with jax.enable_x64(True):
        ref = jscheme2.matmul(jnp.asarray(a), jnp.asarray(b),
                              JCfg(scheme="ozaki2", p=p))
    out = scheme2.matmul(t(a), t(b), EmulationConfig(scheme="ozaki2", p=p))
    assert out.dtype == F64
    _same(out, ref)
    # DGEMM grade: p = 15 and 16 carry about 50 bits here.
    exact = a.astype(np.longdouble) @ b.astype(np.longdouble)
    rel = float(np.abs(out.numpy() - exact).max() / np.abs(exact).max())
    assert rel < {9: 2.0 ** -25, 12: 2.0 ** -36, 15: 2.0 ** -46,
                  16: 2.0 ** -48}[p], rel


@pytest.mark.parametrize("p", [8, 16])
def test_float32_operands_to_float64_output(p):
    """float32 operands integerize in float32 with int32 residues, and a
    float64 output reconstructs in float64 double-double: the reference
    under x64."""
    rng = np.random.default_rng(p)
    a, b = conditioned(rng, (40, 72)), conditioned(rng, (72, 24))
    with jax.enable_x64(True):
        ref = jscheme2.matmul(jnp.asarray(a), jnp.asarray(b),
                              JCfg(scheme="ozaki2", p=p), jnp.float64)
    out = scheme2.matmul(t(a), t(b), EmulationConfig(scheme="ozaki2", p=p),
                         F64)
    _same(out, ref)


def test_subnormal_float64_rows_match_reference_under_daz():
    rng = np.random.default_rng(3)
    a, b = _f64(rng, (16, 48)), _f64(rng, (48, 16))
    a[2] = 1e-310                          # a subnormal-only row
    a[4, ::5] = 3e-310                     # subnormals beside normals
    b[:, 1] *= 1e-300
    with jax.enable_x64(True):
        ref = jscheme2.matmul(jnp.asarray(a), jnp.asarray(b),
                              JCfg(scheme="ozaki2", p=12))
    assert torch.set_flush_denormal(True)
    try:
        out = scheme2.matmul(t(a), t(b), EmulationConfig(scheme="ozaki2",
                                                         p=12))
    finally:
        torch.set_flush_denormal(False)
    _same(out, ref)


def test_ops_route_float64_matches_reference():
    """The residue route (K5's plain version on CPU tensors) against the
    reference's, whose K5 runs in interpret mode; and the fused route."""
    rng = np.random.default_rng(11)
    a, b = _f64(rng, (128, 128)), _f64(rng, (128, 128))
    cfg = EmulationConfig(scheme="ozaki2", p=12)
    with jax.enable_x64(True):
        ref = jops.fused_scheme2_matmul(jnp.asarray(a), jnp.asarray(b),
                                        JCfg(scheme="ozaki2", p=12),
                                        out_dtype=jnp.float64)
    out = ops.fused_scheme2_matmul(t(a), t(b), cfg, out_dtype=F64)
    _same(out, ref)
    assert torch.equal(out, dispatch.emulated_matmul(t(a), t(b), cfg=cfg,
                                                     backend="cuda"))


def test_fused_2d_float64_plain_matches_reference_gpu_kernel():
    """K5g's plain version (the 'cuda' backend's wrapper on CPU tensors)
    against the reference's fused GPU lowering in interpret mode, ragged."""
    rng = np.random.default_rng(5)
    a, b = _f64(rng, (50, 70)), _f64(rng, (70, 33))
    with jax.enable_x64(True):
        ref = jdispatch.emulated_matmul(
            jnp.asarray(a), jnp.asarray(b),
            cfg=JCfg(scheme="ozaki2", p=15, backend="gpu"))
    before = ozaki2.COUNTS.plain_cuda_calls
    out = dispatch.emulated_matmul(t(a), t(b), cfg="ozaki2-m15",
                                   backend="cuda")
    assert ozaki2.COUNTS.plain_cuda_calls == before
    _same(out, ref)


@pytest.mark.parametrize("transposed", [False, True])
def test_batched_float64_route_matches_reference(transposed):
    """The batched route (K6's plain version) through
    dispatch.emulated_matmul_batched against the reference's batched GPU
    lowering, on plain operands and on transposed views."""
    rng = np.random.default_rng(7 + transposed)
    bt, m, k, n = 3, 24, 40, 20
    a = _f64(rng, (bt, m, k))
    b = _f64(rng, (bt, n, k) if transposed else (bt, k, n))
    ta, tb = t(a), t(b)
    with jax.enable_x64(True):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        if transposed:
            ja, jb = ja, jnp.swapaxes(jb, -1, -2)
        cfg = JCfg(scheme="ozaki2", p=12, backend="gpu")
        ref = jdispatch.emulated_matmul_batched(ja, jb, cfg=cfg)
        ref1 = jscheme2.matmul(ja[1], jb[1], cfg)
    if transposed:
        tb = tb.transpose(-1, -2)
    out = dispatch.emulated_matmul_batched(ta, tb, cfg="ozaki2-m12",
                                           backend="cuda")
    _same(out, ref)
    _same(out[1], ref1)
