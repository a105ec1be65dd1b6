"""The port's Scheme II (repro_torch.core.{dd,scheme2}, kernels/ozaki2.py,
kernels/ops.py, the backends' Scheme-II paths) against the JAX reference,
bit for bit.

The same seeded numpy inputs go through both packages. The pipeline
pieces (double-double ops, integerize, balanced residues, Garner digits,
the CRT) and ``scheme2.matmul`` for m in {4, 6, 8, 16} must agree in
every bit, float32 and bfloat16, aligned and ragged. The plain versions
of the EmuGEMM-II kernel's three launch forms are held against the JAX
package's own kernels as its tests run them on the CPU: the residue
kernel (K5) in interpret mode, the fused GPU lowerings (K5g, K6) through
``backend="gpu"``. Subnormal inputs are compared under flush-to-zero,
which is what XLA:CPU does (ROADMAP.md § 3 H1). The kernel itself is held
to these plain versions on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import bits, t
from conftest import conditioned
from repro import api as japi
from repro.core import dd as jdd, scheme2 as jscheme2
from repro.core.precision import EmulationConfig as JCfg
from repro.kernels import dispatch as jdispatch, ops as jops, ozaki2 as jozaki2
from repro.kernels import ref as jref
from repro_torch import api as tapi
from repro_torch.core import dd, scheme2
from repro_torch.core.precision import (DEFAULT_MODULI, EmulationAccuracyError,
                                        EmulationConfig, default_moduli)
from repro_torch.kernels import dispatch, ops, ozaki2

MODULI_COUNTS = [4, 6, 8, 16]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _same(x, y):
    """Bitwise equality of a torch tensor and a jax array (through
    float32 for bf16, exact; ints compared as values)."""
    if x.is_floating_point():
        np.testing.assert_array_equal(bits(x), bits(np.asarray(
            jnp.asarray(y).astype(jnp.float32))))
    else:
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _pair_t(a, b, dtype):
    tt, jt = DTYPES[dtype]
    ja, jb = jnp.asarray(a).astype(jt), jnp.asarray(b).astype(jt)
    ta = t(np.asarray(ja.astype(jnp.float32)), tt)
    tb = t(np.asarray(jb.astype(jnp.float32)), tt)
    return ja, jb, ta, tb


# ---------------------------------------------------------------------------
# Double-double.
# ---------------------------------------------------------------------------

def test_dd_ops_bit_identical():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4096) * np.exp2(rng.integers(-40, 40, 4096))
         ).astype(np.float32)
    b = (rng.standard_normal(4096) * np.exp2(rng.integers(-40, 40, 4096))
         ).astype(np.float32)
    big, small = np.where(np.abs(a) >= np.abs(b), a, b), \
        np.where(np.abs(a) >= np.abs(b), b, a)
    digits = rng.integers(-128, 129, 4096).astype(np.float32)
    assert dd._split_constant(torch.float32) == jdd._split_constant(
        jnp.float32) == 4097.0
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
                                  jnp.asarray(digits))),
            (dd.add2(t(big), t(small), t(b), t(a)),
             jdd.add2(jnp.asarray(big), jnp.asarray(small), jb, ja))):
        for x, y in zip(got, want):
            _same(x, y)
    # two_prod is exact: p + e == a * b in float64.
    p, e = dd.two_prod(t(a), t(b))
    np.testing.assert_array_equal(p.double() + e.double(),
                                  a.astype(np.float64) * b)


# ---------------------------------------------------------------------------
# Integerize, residues, the int32 bound.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("budget", [8, 19, 24])
def test_integerize_bit_identical(dtype, budget):
    rng = np.random.default_rng(budget)
    a = conditioned(rng, (12, 40), phi=4.0)
    a[1] = 0.0                                   # an all-zero row
    a[3] = 1e-40                                 # a subnormal-only row
    a[5, ::3] = 3e-39                            # subnormals beside normals
    a[7] *= 1e30                                 # wide-range rows
    a[8] *= 1e-30
    tt, jt = DTYPES[dtype]
    ja = jnp.asarray(a).astype(jt)
    ta = t(np.asarray(ja.astype(jnp.float32)), tt)
    for axis in (1, 0):
        ref_int, ref_mu = jscheme2.integerize(ja, axis=axis,
                                              budget_bits=budget)
        assert torch.set_flush_denormal(True)
        try:
            got_int, got_mu = scheme2.integerize(ta, axis, budget)
        finally:
            torch.set_flush_denormal(False)
        assert got_int.dtype == got_mu.dtype == tt
        _same(got_mu, ref_mu)
        _same(got_int, ref_int)


def test_balanced_residues_of_negative_values():
    rng = np.random.default_rng(1)
    x = rng.integers(-(2 ** 24) + 1, 2 ** 24, (7, 33)).astype(np.float32)
    x[0, :5] = [-1, -128, -129, -256, -257]
    moduli = DEFAULT_MODULI
    got = scheme2.balanced_residues(t(x), moduli)
    ref = jscheme2.balanced_residues(jnp.asarray(x), moduli)
    assert got.dtype == torch.int8
    _same(got, ref)
    with pytest.raises(ValueError, match="exceed 256"):
        scheme2.balanced_residues(t(x), (257,))


def test_check_exact_k_refuses_exactly_where_the_reference_does():
    moduli = default_moduli(6)                  # max modulus 256
    for k in (131071, 131072):
        refused = []
        for fn in (scheme2.check_exact_k, jscheme2.check_exact_k):
            try:
                fn(k, moduli)
                refused.append(False)
            except (EmulationAccuracyError, ValueError):
                refused.append(True)
        assert refused == [k == 131072] * 2, (k, refused)
    with pytest.raises(EmulationAccuracyError, match="K <= 131071"):
        scheme2.check_exact_k(131072, moduli)


# ---------------------------------------------------------------------------
# Garner and the CRT.
# ---------------------------------------------------------------------------

def _residues_of(x: np.ndarray, moduli) -> np.ndarray:
    return np.stack([np.mod(x, m) for m in moduli]).astype(np.int32)


@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_garner_and_crt_bit_identical(p):
    moduli = default_moduli(p)
    rng = np.random.default_rng(p)
    big = min(int(np.prod([float(m) for m in moduli]) // 4), 2 ** 62)
    x = rng.integers(-big, big, (9, 17), dtype=np.int64)
    x[0, :4] = [0, 1, -1, big - 1]
    x[1] = rng.integers(-2 ** 20, 2 ** 20, 17)      # small values
    res = _residues_of(x, moduli)
    got = scheme2.garner_digits(t(res), moduli)
    ref = jscheme2.garner_digits(jnp.asarray(res), moduli)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        _same(g, r)
    hi, lo = scheme2.mixed_radix_to_dd(got, moduli)
    jhi, jlo = jscheme2.mixed_radix_to_dd(ref, moduli)
    _same(hi, jhi)
    _same(lo, jlo)
    for out_dtype, jout in DTYPES.values():
        c = scheme2.crt_reconstruct(t(res), moduli, out_dtype)
        assert c.dtype == out_dtype
        _same(c, jscheme2.crt_reconstruct(jnp.asarray(res), moduli, jout))
    # The reconstruction is the centered value, rounded.
    np.testing.assert_array_equal(
        scheme2.crt_reconstruct(t(res), moduli, torch.float32).numpy(),
        x.astype(np.float32))


# ---------------------------------------------------------------------------
# The whole pipeline, and the kernel forms' plain versions.
# ---------------------------------------------------------------------------

SHAPES = [(32, 64, 48), (37, 100, 29)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mkn", SHAPES)
@pytest.mark.parametrize("p", MODULI_COUNTS)
def test_matmul_bit_identical_to_reference(p, mkn, dtype):
    m, k, n = mkn
    rng = np.random.default_rng(100 * p + m)
    ja, jb, ta, tb = _pair_t(conditioned(rng, (m, k)),
                             conditioned(rng, (k, n)), dtype)
    ref = jscheme2.matmul(ja, jb, JCfg(scheme="ozaki2", p=p))
    out = scheme2.matmul(ta, tb, EmulationConfig(scheme="ozaki2", p=p))
    assert out.dtype == DTYPES[dtype][0]
    _same(out, ref)
    # The dispatcher entry point runs the same pipeline.
    assert torch.equal(scheme2.fused_matmul(
        ta, tb, EmulationConfig(scheme="ozaki1", p=p)), out)


@pytest.mark.parametrize("p", [4, 6, 8])
def test_residue_form_plain_matches_reference_kernel(p):
    """K5: the plain version against ozaki2.fused_residue_matmul in
    interpret mode (and the reference's oracle)."""
    moduli = default_moduli(p)
    rng = np.random.default_rng(p)
    a_res = rng.integers(-128, 128, (p, 128, 128)).astype(np.int8)
    b_res = rng.integers(-128, 128, (p, 128, 128)).astype(np.int8)
    ref = jozaki2.fused_residue_matmul(jnp.asarray(a_res), jnp.asarray(b_res),
                                       moduli)
    _same(ozaki2.fused_residue_matmul_plain(t(a_res), t(b_res), moduli), ref)
    # The wrapper takes the plain version for CPU tensors, and the oracle
    # agrees on a ragged shape too.
    a2, b2 = a_res[:, :37, :100], b_res[:, :100, :29]
    _same(ozaki2.fused_residue_matmul(t(a2), t(b2), moduli),
          jref.scheme2_residues(jnp.asarray(a2), jnp.asarray(b2), moduli))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("p", [4, 6])
@pytest.mark.parametrize("mkn", [(64, 96, 80), (100, 200, 77)])
def test_fused_2d_plain_matches_reference_gpu_kernel(mkn, p, dtype):
    """K5g: the 'cuda' backend (its wrapper runs the plain version on CPU
    tensors) against the reference's fused GPU lowering in interpret
    mode, aligned and ragged."""
    m, k, n = mkn
    rng = np.random.default_rng(p + m)
    ja, jb, ta, tb = _pair_t(conditioned(rng, (m, k)),
                             conditioned(rng, (k, n)), dtype)
    ref = jdispatch.emulated_matmul(
        ja, jb, cfg=JCfg(scheme="ozaki2", p=p, backend="gpu"))
    before = ozaki2.COUNTS.plain_cuda_calls
    out = dispatch.emulated_matmul(ta, tb, cfg=f"ozaki2-m{p}",
                                   backend="cuda")
    assert ozaki2.COUNTS.plain_cuda_calls == before
    _same(out, ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("transposed", [False, True])
def test_batched_plain_matches_reference_gpu_kernel(transposed, dtype):
    """K6: one strided-batched call against the reference's batched GPU
    lowering, on plain operands and on the transposed views that the
    batched backward passes."""
    rng = np.random.default_rng(7 + transposed)
    bt, m, k, n = 3, 48, 64, 40
    a = conditioned(rng, (bt, m, k))
    b = conditioned(rng, (bt, n, k) if transposed else (bt, k, n))
    ja, jb, ta, tb = _pair_t(a, b, dtype)
    if transposed:
        jb, tb = jnp.swapaxes(jb, -1, -2), tb.transpose(-1, -2)
    cfg = JCfg(scheme="ozaki2", p=6, backend="gpu")
    ref = jdispatch.emulated_matmul_batched(ja, jb, cfg=cfg)
    out = dispatch.emulated_matmul_batched(ta, tb, cfg="ozaki2-m6",
                                           backend="cuda")
    _same(out, ref)
    # ... which is scheme2.matmul element by element.
    _same(out[2], jscheme2.matmul(ja[2], jb[2], cfg))


def test_ops_route_matches_reference_and_fused_route():
    rng = np.random.default_rng(11)
    a = conditioned(rng, (128, 128))
    b = conditioned(rng, (128, 128))
    cfg = EmulationConfig(scheme="ozaki2", p=6)
    ref = jops.fused_scheme2_matmul(jnp.asarray(a), jnp.asarray(b),
                                    JCfg(scheme="ozaki2", p=6))
    out = ops.fused_scheme2_matmul(t(a), t(b), cfg)
    _same(out, ref)
    assert torch.equal(out, dispatch.emulated_matmul(t(a), t(b), cfg=cfg,
                                                     backend="cuda"))
    with pytest.raises(ValueError, match="ozaki2-only"):
        ops.fused_scheme2_matmul(t(a), t(b), "ozaki1-p4")


def test_cuda_backend_refuses_17_moduli_and_torch_runs_them():
    moduli = DEFAULT_MODULI + (181,)
    cfg = EmulationConfig(scheme="ozaki2", p=17, moduli=moduli)
    rng = np.random.default_rng(5)
    a, b = conditioned(rng, (8, 32)), conditioned(rng, (32, 8))
    with pytest.raises(NotImplementedError, match="at most 16 moduli"):
        dispatch.emulated_matmul(t(a), t(b), cfg=cfg, backend="cuda")
    out = dispatch.emulated_matmul(t(a), t(b), cfg=cfg, backend="torch")
    _same(out, jscheme2.matmul(jnp.asarray(a), jnp.asarray(b),
                               JCfg(scheme="ozaki2", p=17, moduli=moduli)))


def test_einsum_front_door_matches_reference():
    """The attention-score contraction through both front doors, which
    canonicalize onto the strided-batched core."""
    rng = np.random.default_rng(3)
    q = conditioned(rng, (2, 5, 2, 2, 16))        # b q k g d
    kk = conditioned(rng, (2, 7, 2, 16))          # b j k d
    eq = "bqkgd,bjkd->bkgqj"
    ref = japi.einsum(eq, jnp.asarray(q), jnp.asarray(kk),
                      precision="ozaki2-m6")
    out = tapi.einsum(eq, t(q), t(kk), precision="ozaki2-m6")
    assert out.shape == ref.shape
    _same(out, ref)
