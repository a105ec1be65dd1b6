"""The port's Scheme-I plain version against the JAX reference, and the
EmuGEMM-I kernel wrapper (repro_torch.core.scheme1, kernels/ozaki1.py).

float32: bit-identical to repro.core.scheme1.matmul for p in {3, 4, 6},
on aligned, ragged and subnormal rows. bfloat16: within 1 bf16 ulp of the
reference (both round int32 -> bf16 through float32 today, so the check
sees 0 ulp; the stated tolerance covers XLA rounding the conversion
directly). The kernel itself is held to the plain version on the card
in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import bits, t
from conftest import conditioned
from repro.core import scheme1 as jscheme1
from repro.core.precision import EmulationConfig as JCfg
from repro_torch.core import scheme1
from repro_torch.core.precision import EmulationConfig
from repro_torch.kernels import ozaki1

SHAPES = [(32, 64, 48), (37, 100, 29), (4, 128, 96)]


def _pair(rng, m, k, n):
    return conditioned(rng, (m, k)), conditioned(rng, (k, n))


@pytest.mark.parametrize("p", [3, 4, 6])
@pytest.mark.parametrize("mkn", SHAPES)
def test_f32_bit_identical_to_reference(p, mkn):
    a, b = _pair(np.random.default_rng(p), *mkn)
    ref = jscheme1.matmul(jnp.asarray(a), jnp.asarray(b),
                          JCfg(scheme="ozaki1", p=p))
    out = scheme1.matmul(t(a), t(b), EmulationConfig(scheme="ozaki1", p=p))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(bits(out), bits(ref))


@pytest.mark.parametrize("p", [3, 4, 6])
def test_bf16_within_one_ulp_of_reference(p):
    a, b = _pair(np.random.default_rng(10 + p), 37, 100, 29)
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    jb = jnp.asarray(b).astype(jnp.bfloat16)
    ref = np.asarray(jscheme1.matmul(ja, jb, JCfg(scheme="ozaki1", p=p))
                     .astype(jnp.float32))
    ta = t(np.asarray(ja.astype(jnp.float32)), torch.bfloat16)
    tb = t(np.asarray(jb.astype(jnp.float32)), torch.bfloat16)
    out = scheme1.matmul(ta, tb, EmulationConfig(scheme="ozaki1", p=p))
    assert out.dtype == torch.bfloat16
    ulp = np.maximum(np.abs(ref), np.finfo(np.float32).tiny) * 2.0 ** -7
    assert np.all(np.abs(out.float().numpy() - ref) <= ulp)


@pytest.mark.parametrize("p", [3, 4])
def test_subnormal_rows_match_reference_under_daz(p):
    """XLA:CPU flushes subnormal inputs (DAZ); the comparison sets the
    same mode in torch (ROADMAP.md § 3 H1)."""
    rng = np.random.default_rng(3)
    a, b = _pair(rng, 8, 40, 16)
    a[2] = 1e-40                     # a subnormal-only row
    a[5, ::3] = 3e-39                # subnormals beside normals
    b[:, 4] = 0.0                    # an all-zero column
    ref = jscheme1.matmul(jnp.asarray(a), jnp.asarray(b),
                          JCfg(scheme="ozaki1", p=p))
    assert torch.set_flush_denormal(True)
    try:
        out = scheme1.matmul(t(a), t(b), EmulationConfig(scheme="ozaki1", p=p))
    finally:
        torch.set_flush_denormal(False)
    np.testing.assert_array_equal(bits(out), bits(ref))


def test_exact_pow2_is_exact_and_clamped():
    e = torch.tensor([-200, -126, -125, 0, 1, 120, 127, 128, 300])
    got = scheme1.exact_pow2(e, torch.float32)
    want = [2.0 ** -126, 2.0 ** -126, 2.0 ** -125, 1.0, 2.0, 2.0 ** 120,
            2.0 ** 127, np.inf, np.inf]
    assert got.tolist() == want
    ref = jscheme1.exact_pow2(jnp.asarray(e.numpy()), jnp.float32)
    np.testing.assert_array_equal(bits(got), bits(ref))
    assert scheme1.exact_pow2(torch.tensor([3]), torch.bfloat16).item() == 8.0
    assert scheme1.exact_pow2(torch.tensor([-2000]),
                              torch.float64).item() == 2.0 ** -1022


def test_split_reconstructs_within_residual_bound():
    a = t(conditioned(np.random.default_rng(0), (16, 64)))
    sl, mu = scheme1.split(a, 4, 7, axis=-1)
    w = torch.tensor([2.0 ** (-7 * (i + 1)) for i in range(4)],
                     dtype=torch.float64)
    recon = (sl.double() * w[:, None, None]).sum(0) * mu.double()
    assert torch.all((recon - a.double()).abs() <= mu.double() * 2.0 ** -28)


@pytest.mark.parametrize("batched", [False, True])
def test_wrapper_runs_plain_version_on_cpu(batched):
    rng = np.random.default_rng(1)
    shape_a, shape_b = ((3, 20, 40), (3, 40, 24)) if batched else \
        ((20, 40), (40, 24))
    a = t(conditioned(rng, shape_a))
    b = t(conditioned(rng, shape_b))
    mu, nu = scheme1.pow2_scale(a, -1), scheme1.pow2_scale(b, -2)
    before = (ozaki1.COUNTS.launches_2d, ozaki1.COUNTS.launches_batched,
              ozaki1.COUNTS.plain_cuda_calls)
    out = ozaki1.fused_matmul_scheme1(a, b, mu, nu, 4, 7, torch.float32)
    ref = scheme1.matmul(a, b, EmulationConfig(scheme="ozaki1", p=4))
    assert torch.equal(out, ref)
    after = (ozaki1.COUNTS.launches_2d, ozaki1.COUNTS.launches_batched,
             ozaki1.COUNTS.plain_cuda_calls)
    assert after == before           # CPU work is neither a launch nor a
    #                                  plain call on a CUDA tensor
